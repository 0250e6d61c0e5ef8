#!/usr/bin/env python3
"""Smoke run of the PyTorch port (structured_latent_odes_tpu_torch) on one
CUDA card: the quickest proof that the port builds, serves and trains on the
GPU.

    python3 chip_smoke.py              # on the card
    python3 chip_smoke.py --cards      # phases 1, 2 and 11 only (four cards)
    python3 chip_smoke.py --rehearse   # on the CPU: plain versions, tiny sizes

Phases, each fatal on any fault:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel from csrc/, one nvcc per source and width pair, all
   started together: K1, the conv encoder's pair (one library for every
   shape), and K2 and K3 (single-member and member-batched launches share a
   library) at CVS's and challenge's (H, D) = (25, 5), proc's (25, 8) and
   the wide (40, 17) and (128, 32); prints nvcc's -Xptxas -v report and each
   kernel's registers and spills per method.
3. kernels: K1 (affine scan), K1-bwd (its reverse sweep), K2 (fused
   semilinear solve) and K3 (its reverse sweep) against their plain PyTorch
   versions on the card: K1 and K1-bwd bit for bit at the edges of their
   batch-major layout and at the proc and challenge shapes (K1_SHAPES,
   B = 16,411 among them), K2 and K3 at the serving and training shapes and
   B = 16,411 and at the edges of their layout (B = 1, 2, 130 by T = 2, 86,
   200, every method), and at proc's (B = 36, 78 by T = 100, D = 8) and
   challenge's (B = 32, 7 by T = 142: 141 steps, two passes) shapes, every
   method; then each timed at B = 100, 128 and 16,411 and at the proc and
   challenge training shapes beside the plain version and the bound on an
   H100 SXM: the kernel's device time from a CUDA event pair right around
   each launch (queued behind a device-side sleep, so no host gap falls
   inside), and the wrapper call (argument preparation included) and the
   plain version with CUDA events after warm-up; and the whole affine_scan
   call at B = 128, forward alone and forward plus backward. Then C1: K1
   and K1-bwd through the model's entry past their shared-memory cap, at
   T = 4096 with D = 5 and D = 8 (the time axis split into runs), bit for
   bit the plain versions, their launches per call and times, and one
   training step of the decoder ODE on semilinear at that horizon and
   width (gradient through the split K1/K1-bwd, an Adam update); and the
   member-batched K2 and K3 (an ensemble's members on blockIdx.y) at the
   CVS sweep's shape (S = 10, B = 128, (H, D) = (25, 5)) and the proc
   sweep's (S = 5, B = 36, (25, 8)), midpoint: each member bit for bit a
   single-member launch, within K2's and K3's tolerances of the plain
   versions, timed beside them, the bound at S*B and S single-member calls.
   Then the conv encoder's forward and weight-gradient kernels (conv1d,
   bias, average pool and flatten; csrc/conv_encoder.cu) at CVS's, proc's
   and challenge's encoders and training batches and at ten members of the
   CVS and proc sweeps: against their plain versions in float64, a second
   launch bit for bit the first, each member bit for bit a single-member
   launch (with its own observations and with one set shared by all), each
   timed beside its plain version, its bound and cuDNN's way of the same
   work.
4. serving path: generates CVS with the port's make_dataset on the card, writes
   two random-weight checkpoints (seeds 0 and 1) in the JAX package's format,
   and serves them through serve.main: posterior recon, prior recon with
   --classify, and the ensemble mean of both, on the backends semilinear
   (K1), semilinear_pallas (K1), semilinear_fused (K2) and semilinear_seq
   (plain), plus one Gauss-model request. Launch counts are zeroed just before
   each backend's requests and read just after: each backend must launch its
   own forward kernel and no other K1-K3 kernel, and the conv encoder's
   forward. Outputs are checked for shape,
   finiteness and agreement across backends. Then a served request is timed at B = 100 and
   B = 16,411 per backend.
5. training path: training_cvs.main at full width (--num-epochs 1: epochs 0
   and 1, 14 dual steps, per-epoch val/train statistics, the final test
   evaluation) on the same data with the backends semilinear (K1, K1-bwd),
   semilinear_fused (K2, K3) and semilinear_seq (plain), plus one Gauss-model
   run. Launch counts are zeroed just before each run and read just after:
   each run must launch its backend's forward and backward kernels and no
   other (semilinear_seq none), and the conv encoder's forward and weight
   gradient on every backend. Every logged loss must be finite, the
   artifacts must have the JAX package's shapes, and the trained checkpoint
   is served through serve.main. Then the first dual step's losses and
   gradients are compared across the three backends from one set of params
   and one seed, with the counts read per backend as above, and one dual
   step at B = 128 is timed per backend.
6. proc and challenge, served and trained at full width on the datasets in
   datasets/ (the port's loaders, no generated data): two random-weight
   checkpoints each, served through serve.main (posterior, prior with
   --classify, the ensemble mean of both) on semilinear, semilinear_fused
   and semilinear_seq plus one Gauss request; training_proc.main and
   training_challenge.main with --num-epochs 1 and the config's 200-draw
   sample bands on the same three backends plus one Gauss run, each trained
   checkpoint served; the first dual step compared across the backends; one
   dual step timed per backend (proc at B = 36, challenge at B = 32). Launch
   counts are zeroed and read per backend's requests and per run, as for CVS.
7. ensembles: one stacked dual step (svi.make_stacked_dual_step) at the CVS
   training batch on semilinear and semilinear_fused, with its kernel
   launches (equal at S = 1 and S = 10) and device operations (profiler)
   at S = 1, 2 and 10, its time at S = 1 and 10 and ten sequential dual
   steps beside it; then sweep.run at full width: CVS over seeds 12..21 on
   semilinear and semilinear_fused, proc over seeds 12..16 on
   semilinear_fused, one epoch beyond epoch 0, launches counted per sweep
   (each launches the member-batched conv encoder's pair);
   each sweep must print "epoch dispatch: cuda graph" and replay graphs.
   Every member's artifacts exist and are finite, sweep.json parses,
   deploy_mean/ is written, and members 0 and S-1 match the port's
   sequential CLI run at their seeds (final and best params within rtol
   2e-4, atol 1e-6; best epoch equal; criterion within rtol 2e-4).
8. the rest of solve_ode. C2's kernels (built in phase 2, held against their
   plain versions in phase 3: K2/K3 at dopri5 at (25, 5) and (25, 8), at
   midpoint at (H, D) = (40, 17) and (128, 32), a member-batched dopri5
   launch at S = 5, each with its registers and spills) on the paths that
   run them, each variant's launches counted: CVS and proc on
   semilinear_auto at dopri5, proc's stacked step at S = 5 on
   semilinear_fused at dopri5, the decoder ODE's training step at each wide
   width. Then the ODE backend menu at CVS full width: generic, adjoint,
   adaptive, adaptive_per_sample and semilinear_auto each serve a request
   (B = 100) and take two dual steps (B = 128), timed, with the adaptive
   solvers' trips per solve; generic is held to semilinear, adjoint's
   forward to generic's and its first-step gradients to generic's at rk4
   within rtol 2e-2, atol 1e-2 of each leaf's largest value, the adaptive backends
   to generic at rk4 within rtol 5e-3, atol 5e-3; semilinear_auto's choice is printed per workload and
   launches exactly its path's kernels. Then one CVS training epoch each on
   semilinear_seq, generic and adjoint as a CUDA graph (train/svi.py), bit
   for bit the eager epoch, and one more replayed epoch timed beside the
   eager one. Last, two-member CVS sweeps on
   adjoint and on adaptive (cut to one epoch of 40 trajectories), members
   0 and 1 held to their sequential runs as in phase 7, each printing its
   epoch dispatch (adjoint's a CUDA graph, adaptive's eager).
9. the rest of the training surface. Batch-exact resume at full width:
   training_cvs.main on semilinear_fused (K2, K3) and on semilinear (K1,
   K1-bwd) and training_proc.main on semilinear_fused, each once over
   epochs 0-2 with --checkpoint-every 1 and once over epochs 0-1 followed
   by --resume to epoch 2; every leaf of train_state.npz and best_model.npz
   and every .npy artifact bit for bit equal, and each run launching its
   backend's forward and backward kernels and no other. The profiler trace
   of a CVS run on semilinear_fused (--profile-dir): the file parses and its
   device events name K2's and K3's kernels. The native host library: where
   g++ is on PATH it must build; its parse of the six proc files equals the
   csv parse element for element (host time of both printed) and its pack
   equals the numpy gather at proc's training split. The reference's CVS
   pickles written from the generated data: build_splits from them equals
   the cvs.npz splits, and one epoch trained from each is bit for bit the
   same. 2^20 draws of each of the samplers (Laplace, Bernoulli, one-hot
   categorical) on the card within 5 standard errors of their means and
   variances, the uniform words bit for bit the CPU's. Plotting: without
   matplotlib or scikit-learn a CVS run with plots on must raise naming the
   package and --no-plot before its first launch; with both, one epoch's
   plots are drawn. The phase prints its wall time.
10. ranks (ROADMAP A17; C6), at CVS full width (B = 128, T = 86, latent 15,
   (H, D) = (25, 5)) and, in (b) and (c), also at proc's (B = 36, T = 100,
   latent 50, (25, 8)) and challenge's (B = 32, T = 142, latent 15, (25, 5))
   on their datasets: two ranks spawned once (parallel/launch.py RankPool)
   share cuda:0 over gloo, since NCCL refuses two ranks on one GPU, and run
   every case; the parent computes the one-device references. (a) The
   data-parallel dual step through an NCCL group of one rank, bit for bit
   the one-device step, launching K2 and K3; then two training epochs of
   four steps and the eval epochs (posterior and prior) through it,
   replayed as CUDA graphs with the NCCL sums inside them, bit for bit one
   device's eager epochs and its own eager ones, launches equal. (b) The
   data-parallel dual
   step on both ranks, half the batch each, on semilinear_fused (K2, K3) and
   semilinear (K1, K1-bwd): loss rtol 1e-5, params rtol 1e-4 and atol 1e-5
   of the one-device step, the summed main and aux gradients that the
   step's updates took within 1e-5 of each leaf's largest (at least 1) of
   the one-device step's, the ranks' params bit for bit equal; their
   epoch dispatch names gloo's reason to stay eager. (c) The
   horizon over both ranks (semilinear_timepar): the solve's values, the
   main loss's gradients and a dual step against semilinear on one device,
   launching K1 and K1-bwd, and the recurrence of 4096 steps at the
   workload's ODE state width (solve_affine_recurrence_timepar) against K1.
   (d) A CVS sweep of four
   members over --ensemble-parallel 2 on semilinear_fused, one epoch beyond
   epoch 0, bit for bit the unsharded sweep in member groups of two run in
   this process at its default intra-op thread count, each rank replaying
   CUDA graphs on the card (a seed's weights no
   longer depend on it; within the JAX package's member-sharded bound,
   params rtol 1e-5 and atol 1e-7, Adam's moments within 1e-5 of each
   leaf's largest), and its params against the unsharded stack of all four
   (the stacked-member bound, rtol 2e-4 and atol 1e-6). (e) training_cvs
   with --data-parallel 2 on one card raises before any launch, naming the
   card count. Launch counts are zeroed and read in each rank per case, and
   printed; the times are labelled as two ranks sharing one card over gloo:
   they describe this rehearsal, not the speed of several cards. The phase
   prints a {"ranks": ...} line of its times and worst errors.
11. the layouts across cards over NCCL (ROADMAP C4; C6), where the machine
   has four cards or more (else one line says so), at CVS, proc and
   challenge full width: four ranks spawned once, rank r on cuda:r. (a) The
   data-parallel dual step over the four cards (CVS 32 rows a rank, proc 9,
   challenge 8) and, at CVS, over two of them, on semilinear_fused and
   semilinear, under phase 10's bounds with the ranks' params bit for bit
   equal; the median of five steps and, timed apart, the gradient sums'
   share; each rank's epoch dispatch a CUDA graph. (a') At CVS over four
   cards and over two, on both kernel paths: two training epochs of four
   steps and the eval epochs replayed as CUDA graphs (the NCCL sums
   inside), each rank bit for bit eager or within the data-parallel params
   bound of it (the ratio printed), the ranks bit for bit each other,
   launches equal; a replayed step's time a rank beside one card's
   replayed step, and the NCCL kernels' device time a step from one
   traced replayed epoch. (b) data 2 x time 2 and time 4 on
   semilinear_timepar at each workload, and the recurrence of 4096 steps
   over the time ranks; their dispatch names semilinear_timepar's reason
   to stay eager. (c) A
   CVS sweep of eight members and a proc sweep of four (seeds 12..15) over
   --ensemble-parallel 4 (bit for bit the unsharded sweep in member groups
   of a rank's size) and over --ensemble-parallel 2
   --ensemble-data-parallel 2 (phase 10's member-sharded bound), both
   within the stacked-member bound of all members, each rank under its own
   results root (rank 0 alone must write); each rank of both layouts
   must replay CUDA graphs on its card (2 x 2's data ranks sum over NCCL
   inside them); the gather's time. (d)
   training_cvs, training_proc and training_challenge --data-parallel 4
   spawned by the CLI and under torchrun (bit for bit each other, their
   artifacts elementwise within (a)'s params bound of one card) and the
   sweep CLI over --ensemble-parallel 4 (bit for bit (c)'s CVS sweep). (e)
   --data-parallel 5 raises before any launch. Launches are counted on
   every rank of every case (of the CLIs' own processes at their exit).
   Prints a {"cards": ...} line. --cards runs phases 1, 2 and 11 alone.
12. the training and eval epochs as CUDA graphs (train/svi.py,
   utils/graphs.py), at CVS (B = 128), proc (B = 36) and challenge (B = 32)
   full width on semilinear_fused (K2, K3) and semilinear (K1, K1-bwd): two
   training epochs from one state, replayed (the first warms up on a side
   stream, captures the dual step and replays it; the second only replays)
   and eager, bit for bit equal (params, Adam moments, counts, per-step
   metrics) with equal launches; each eval epoch (val and train, posterior
   and prior) twice, bit for bit eager, launches equal. Median of 5, host
   clock to a synchronize: a dual step (an epoch over its steps), a val eval
   epoch and, at CVS, a whole epoch as the driver runs it (training and the
   four eval epochs), eager and replayed; the host time of a fresh capture
   of the step and of the val eval epoch (its graph.capture span); a traced
   epoch each way (device busy time, idle share, the host's launching calls
   a step). Prints a {"graphs": ...} line (with
   phase 8's menu epochs). The training runs of phases 5, 6 and 9
   replay graphs too: each prints its replays (and the CLI its "epoch
   dispatch: cuda graph" line), and a run that replayed none fails.
13. the sweeps' epochs as CUDA graphs (train/ensemble.py: the stacked dual
   step, the members' val ELBO, the prior refit's update), two epochs of
   sweep.train_ensemble at full width: CVS over seeds 12..21 on
   semilinear_fused and semilinear, proc over 12..16 on semilinear_fused
   with one refit epoch, challenge over 12, 13 on semilinear_fused. Each
   replayed run (fresh captures), its 1-epoch chunks and, at CVS, its
   member groups of 5 bit for bit the eager runs (state, moments, counts,
   best params, criteria and epochs, history), launches equal. Median of
   5, host clock to a synchronize, eager and replayed: the stacked dual
   step (an epoch of it over its steps) at the case's S and at CVS at S =
   1, a sweep epoch (the steps, the val ELBO, the host's selection) and a
   refit step; each capture's time (graph.capture spans); a traced epoch each way
   (device busy time, idle share, host launching calls a step). Its
   numbers join the {"graphs": ...} line under "sweeps".
14. serving's predict functions and the eval functions as CUDA graphs
   (serve.make_predict_fns, svi.make_eval_fns), against eager: posterior
   requests at CVS B = 100 and the tiled 16,411 on semilinear_fused (K2)
   and semilinear (K1), the prior and the classifier at B = 100, and proc
   (val fold, 78) and challenge (val fold, 7) requests on semilinear_fused,
   each call of the graph (its eager first call, its capture and replay, a
   replay) bit for bit the eager call, launches equal; serve.main at CVS,
   proc and challenge (two checkpoints' ensemble mean with --classify,
   posterior and prior) replayed bit for bit its eager run, printing
   `predict dispatch: cuda graph` once; final_test_eval at CVS, proc's
   200-draw sample bands (the six arrays bit for bit) and the selection
   prior L1 of a two-member CVS sweep's members. Median of 5, host clock
   to a synchronize, eager and replayed, and five calls traced each way
   (device busy time, idle share a call; the bands once, at 20 draws a
   mode); each
   capture's time (graph.capture spans). Its numbers join the {"graphs": ...}
   line under "served".

TF32 stays off for matrix products throughout (utils/device.py::full_fp32).
The port runs no cuDNN operation: the encoder's conv runs in its own
kernels. Only phase 3's timing of cuDNN's way of the conv runs cuDNN, with
its deterministic algorithms and TF32 off.

Prints a {"ranks": ...} line, a {"cards": ...} line where phase 11 ran, a
{"graphs": ...} line, a {"kernels": [...]} line, then the nvidia-smi line, then the last line
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from structured_latent_odes_tpu_torch import serve, sweep, training_challenge, training_cvs, training_proc
from structured_latent_odes_tpu_torch.data.configs import LOADERS, load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, init_params, proc_spec
from structured_latent_odes_tpu_torch.nn.ode_model import (
    OdeModelSpec,
    auto_picks_fused,
    initialize_state,
    ode_model_init,
    solve_ode,
)
from structured_latent_odes_tpu_torch.ode import solvers
from structured_latent_odes_tpu_torch.ops import _build, conv_encoder, fused_step, recurrence
from structured_latent_odes_tpu_torch.parallel import launch, timepar
from structured_latent_odes_tpu_torch.parallel import mesh as mesh_module
from structured_latent_odes_tpu_torch.parallel import train as dp_train
from structured_latent_odes_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_stacked
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import checkpoint, ensemble, svi
from structured_latent_odes_tpu_torch.train.driver import device_batch, final_test_eval
from structured_latent_odes_tpu_torch.utils import graphs, profiling
from structured_latent_odes_tpu_torch.utils.device import full_fp32, resolve_device
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.abspath(__file__))
# the card's name and power limit as nvidia-smi reports them, printed beside
# every time (set by main)
CARD = {"smi": ""}
T0 = time.perf_counter()


def phase(name: str) -> None:
    """The start of a phase, with the seconds since the script began."""
    print(f"== [{time.perf_counter() - T0:.1f} s] {name}", flush=True)

# H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

# K1 and K1-bwd do their plain versions' float32 operations in the same
# order: held bit for bit (torch.equal)
K1_RULE = "torch.equal(out, ref): bit for bit"
# K2 and the backends, elementwise |out - ref| <= ATOL + RTOL*|ref|, the JAX
# package's own tolerance for its fused kernel (tests/test_fused_step.py):
# at random weights trajectories reach |x| of tens, where float32 roundoff
# accumulated over 85 steps differs by up to ~1e-6 relative between two
# summation orders (measured on the H100: 6.9e-5 abs at |x| = 78)
ATOL, RTOL = 1e-5, 1e-5
# K3's weight gradients (w_t, W_a, b_a, W_d, b_d) are sums over the batch,
# the steps and the stages: up to 16,411 * 85 * 4 = 5.6M float32 terms, summed
# per thread, per block and across blocks here and per step over the batch in
# the plain version. Each leaf is held to max|out - ref| <= WGRAD_RTOL *
# max|ref| of that leaf; phase 3 prints each error / tolerance.
WGRAD_RTOL = 1e-5
# K3's du (per trajectory) is a sum over the 85 * S stages of terms that
# cancel: its float32 error follows the terms, not the result, so K2's purely
# elementwise 1e-5 + 1e-5*|ref| failed by 1.6x at euler, B = 128 (H100). du is
# held to |out - ref| <= DU_ATOL * max|ref| + RTOL * |ref|; phase 3 prints
# both ratios, and the kernels line the one held.
DU_ATOL = 1e-5
# each kernel's outputs: (name, rule as printed in the kernels line)
MEMBER_RULE = "torch.equal(member s, a single-member launch on member s's slices): bit for bit"
TOLERANCE_RULES = {
    "K1": {"xs": K1_RULE},
    "K1-bwd": {name: K1_RULE for name in ("dA", "dB", "dx0")},
    "K2": {"xs": f"|out - ref| <= {ATOL:g} + {RTOL:g}*|ref|, elementwise"},
    "K3": {
        "du": f"|out - ref| <= {DU_ATOL:g}*max|ref| + {RTOL:g}*|ref|, elementwise",
        **{name: f"max|out - ref| <= {WGRAD_RTOL:g}*max|ref| of the leaf"
           for name in ("dwt", "dwa", "dba", "dwd", "dbd")},
        "dx0": f"|out - ref| <= {ATOL:g} + {RTOL:g}*|ref|, elementwise",
    },
}
# the member-batched launches: each member bit for bit a single-member
# launch, and against the plain versions under K2's and K3's rules
TOLERANCE_RULES["K2-members"] = {"single-member launch": MEMBER_RULE, **TOLERANCE_RULES["K2"]}
TOLERANCE_RULES["K3-members"] = {"single-member launch": MEMBER_RULE, **TOLERANCE_RULES["K3"]}
# the conv encoder's kernels against their plain versions in float64 on the
# host (the card's F.conv1d is cuDNN's, another float32 order): the forward,
# K * W products and a pool's means an output, elementwise as K2; each
# weight-gradient leaf, a sum of B * n_conv products, against its largest
# value as K3's. A second launch on the same inputs is bit for bit the
# first: the weight gradient sums its blocks in a fixed order, no atomics.
CONV_FWD_RULE = f"|out - ref| <= {ATOL:g} + {RTOL:g}*|ref|, elementwise, ref in float64"
CONV_WGRAD_RULE = f"max|out - ref| <= {WGRAD_RTOL:g}*max|ref| of the leaf, ref in float64"
REPEAT_RULE = "torch.equal(a second launch, the first): bit for bit"
TOLERANCE_RULES["conv_pool_fwd"] = {"y": CONV_FWD_RULE, "repeat": REPEAT_RULE}
TOLERANCE_RULES["conv_pool_wgrad"] = {"dw": CONV_WGRAD_RULE, "db": CONV_WGRAD_RULE, "repeat": REPEAT_RULE}
TOLERANCE_RULES["conv_pool_fwd_members"] = {"single-member launch": MEMBER_RULE, **TOLERANCE_RULES["conv_pool_fwd"]}
TOLERANCE_RULES["conv_pool_wgrad_members"] = {"single-member launch": MEMBER_RULE,
                                              **TOLERANCE_RULES["conv_pool_wgrad"]}
# first-step gradients across the three backends: max|g - g_seq| /
# max(max|g_seq|, 1) over every leaf, the JAX package's own fused-vs-autodiff
# bound (tests/test_fused_step.py): float32 accumulation order
STEP_GRAD_TOL = 5e-3
BIG_B = 16411
TRAIN_B = 128
SERVE_B = 100
# K1 and K1-bwd (Bt, T, D) at the edges of their layout (csrc/affine_scan.cu:
# four whole trajectories per block): one step, one trajectory, a tile's
# ragged edge (3, 7, 130), 199 steps (past the default 48 KB of shared memory
# backward), D = 8, the serving batch (the CVS test split), the training
# batch and BIG_B; then the proc and challenge workloads' training batches
# and val folds over their horizons
K1_SHAPES = ((1, 1, 5), (1, 85, 5), (3, 85, 5), (SERVE_B, 85, 5), (TRAIN_B, 85, 5), (130, 199, 5), (7, 85, 8),
             (BIG_B, 85, 5), (36, 99, 8), (78, 99, 8), (32, 141, 5), (7, 141, 5))

# the proc and challenge workloads at the repo's configs: the spec, the
# training driver, the training batch (proc's config: 36; challenge's 100
# clamped to its 28 train subjects: 32), the val fold (served, tested and
# sampled as one split), the horizon and the ODE state width
WORKLOADS = {
    "proc": dict(spec=proc_spec, driver=training_proc, train_b=36, val_b=78, T=100, D=8),
    "challenge": dict(spec=challenge_spec, driver=training_challenge, train_b=32, val_b=7, T=142, D=5),
}

K1_SOURCE = "structured_latent_odes_tpu_torch/csrc/affine_scan.cu"
K2_SOURCE = "structured_latent_odes_tpu_torch/csrc/fused_semilinear_fwd.cu"
K3_SOURCE = "structured_latent_odes_tpu_torch/csrc/fused_semilinear_bwd.cu"
K1_REPLACES = "structured_latent_odes_tpu/ops/recurrence.py:39"
K1_BWD_REPLACES = "structured_latent_odes_tpu/ops/recurrence.py:87"
K2_REPLACES = "structured_latent_odes_tpu/ops/fused_step.py:143"
K3_REPLACES = "structured_latent_odes_tpu/ops/fused_step.py:171"
CONV_SOURCE = "structured_latent_odes_tpu_torch/csrc/conv_encoder.cu"
# no TPU kernel: the JAX package's conv and pool are XLA's
CONV_REPLACES = "none: structured_latent_odes_tpu/nn/layers.py:188 (lax.conv_general_dilated and the pool)"
KERNELS = {  # key: wrapper, which counts its launches
    "K1": recurrence.affine_scan_fwd,
    "K1-bwd": recurrence.affine_scan_bwd,
    "K2": fused_step.fused_semilinear_fwd,
    "K3": fused_step.fused_semilinear_bwd,
    # the same kernels launched for an ensemble's S members at once (member
    # on blockIdx.y), through their own wrappers and counts
    "K2-members": fused_step.fused_semilinear_fwd_members,
    "K3-members": fused_step.fused_semilinear_bwd_members,
    # the conv encoder's front end (conv1d, bias, average pool, flatten):
    # forward and weight gradient, for one model and member-batched
    "conv_pool_fwd": conv_encoder.conv_pool_fwd,
    "conv_pool_wgrad": conv_encoder.conv_pool_wgrad,
    "conv_pool_fwd_members": conv_encoder.conv_pool_fwd_members,
    "conv_pool_wgrad_members": conv_encoder.conv_pool_wgrad_members,
}
CONV_KEYS = ("conv_pool_fwd", "conv_pool_wgrad", "conv_pool_fwd_members", "conv_pool_wgrad_members")
# the conv kernels a path runs: a served model's encoder, a trained one's,
# and a sweep's members' (the stacked steps, under torch.func.vmap)
ENCODE = ("conv_pool_fwd",)
ENCODE_TRAIN = ("conv_pool_fwd", "conv_pool_wgrad")
ENCODE_MEMBERS = ("conv_pool_fwd_members", "conv_pool_wgrad_members")
# the conv encoder at each workload's training batch, (members, B) with 0
# members for one model, and at the sweeps' stacked steps, ten members; the
# channels, horizon and filters are the workload's encoder's
CONV_SHAPES = {"cvs": (0, TRAIN_B), "proc": (0, 36), "challenge": (0, 32), "cvs_S10": (10, TRAIN_B),
               "proc_S10": (10, 36)}
# the sweeps' member-batched launches: (S, B, T) of the CVS sweep (ten
# members, the training batch, (H, D) = (25, 5)) and the proc sweep (five
# members, its training batch 36, (25, 8))
MEMBER_SHAPES = {"cvs": (10, TRAIN_B, 86), "proc": (5, 36, 100)}
# K1 and K1-bwd past their shared-memory cap (C1): the model's entry splits
# the time axis into runs; held bit for bit at T = 4096 steps
LONG_T = 4096
# C2: the fused kernels past one warp's lanes, (H, D) at midpoint; and
# dopri5 (seven stages) at the repo's widths
WIDE = ((40, 17), (128, 32))
# the ODE backend menu (phase 8), at CVS full width
MENU = ("generic", "adjoint", "adaptive", "adaptive_per_sample", "semilinear_auto")
# The two-member sweeps on adjoint and adaptive run one epoch (epoch 0) on
# 40 generated trajectories in place of 1,000: 32 train, one dual step an
# epoch at the training batch. The adaptive backends' backward solves each
# of the 85 intervals' augmented system adaptively, one host-synced trip at
# a time, and its step control rejects its way across every discontinuity
# of the relu's derivative: about 110 trips an interval, whatever the batch
# (scripts/menu_step_times.py times a dual step at any batch).
MENU_SWEEP_DATA = 40
# adaptive backends against generic at rk4 (the JAX package's own bound,
# tests/test_solvers.py::test_adaptive_backends_reachable_from_model_path)
ADAPTIVE_RTOL = ADAPTIVE_ATOL = 5e-3
# the continuous adjoint's first-step gradients against generic's autograd
# (tests/test_solvers.py::test_adjoint_gradients_match_discretize)
ADJOINT_RTOL, ADJOINT_ATOL = 2e-2, 1e-2
# -Xptxas -v per library: (name, (H, D)) -> {(kernel, method): (registers,
# spill store bytes, spill load bytes)} (set by phase_build)
PTXAS = {}
# per path: each fused wrapper's launches by (method, H, D) (set by counted)
VARIANT_PATHS = {}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ratio(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float = 0.0) -> float:
    """Worst error / tolerance, max(|out - ref| / (atol + rtol*|ref|)): <= 1
    within tolerance."""
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


class Clock:
    """CUDA-event timing on the card; the host clock in a rehearsal."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def kernel_device_ms(key: str, fn, iters: int = 20, per_call: int = 1) -> float:
    """Device time per call of ``fn`` of kernel ``key``, over ``iters``
    calls, each making ``per_call`` launches: the sum of a call's launches,
    each between a CUDA event pair recorded on the stream right before and
    after it, without the wrapper's other work. A device-side sleep holds the stream back until every call is
    enqueued, so no pair waits on the host; the sleep doubles until the host
    finishes enqueueing inside it. The wrapper's count must rise by exactly
    ``iters * per_call``, each launch bracketed."""
    wrapper = KERNELS[key]
    launch = _build.launch
    pairs = []

    def bracketed(name, f, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(name, f, *args)
        end.record()
        pairs.append((start, end))

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(9):
        pairs.clear()
        before = wrapper.launches
        sleep0, sleep1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _build.launch = bracketed
        try:
            sleep0.record()
            torch.cuda._sleep(cycles)
            sleep1.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            _build.launch = launch
        torch.cuda.synchronize()
        n = wrapper.launches - before
        check(n == iters * per_call == len(pairs),
              f"{key}: {n} launches counted, {len(pairs)} bracketed, expected {iters * per_call}")
        if host_ms < sleep0.elapsed_time(sleep1):
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 2
    fail(f"{key}: the host took longer to enqueue {iters} calls than the longest sleep")


def k1_bound_ms(T: int, M: int):
    nbytes = 4 * (2 * T * M + M + (T + 1) * M)
    ops = 2 * T * M
    return bound(nbytes, ops)


def k1_bwd_bound_ms(T: int, M: int):
    """A, g and xs read once (xs rows 0..T-1: the kernel never reads row T);
    dA, dB, dx0 written once; 3 flops per lane-step."""
    nbytes = 4 * (T * M + (T + 1) * M + T * M + 2 * T * M + M)
    return bound(nbytes, 3 * T * M)


def k_params(H: int, D: int) -> int:
    """The fused kernels' packed weights: w_t, W_a, b_a, W_d, b_d."""
    return H + 2 * D * H + 2 * D


def k2_bound_ms(B: int, T: int, S: int, H: int, D: int, members: int = 1):
    """B trajectories in all (over ``members`` weight sets)."""
    nbytes = 4 * (B * H + B * D + members * k_params(H, D) + (T - 1) * (S + 1) + T * D * B)
    ops = B * (T - 1) * S * (4 * D * H + 2 * H)
    return bound(nbytes, ops)


def k3_bound_ms(B: int, T: int, S: int, H: int, D: int, members: int = 1):
    """u, the weights, the tables, xs and g read once; du, dx0 and the weight
    gradients written once (B trajectories in all, over ``members`` weight
    sets). The stage recompute is S(4DH + 2H) flops per trajectory-step and
    the VJP S(8DH + 4H)."""
    nbytes = 4 * (B * H + members * k_params(H, D) + (T - 1) * (S + 1) + 2 * T * D * B + B * H + B * D
                  + members * k_params(H, D))
    ops = B * (T - 1) * S * (12 * D * H + 6 * H)
    return bound(nbytes, ops)


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device(rehearse: bool):
    if rehearse:
        print("== device: rehearsal on the CPU (plain versions, tiny sizes)", flush=True)
        return torch.device("cpu"), "rehearsal: no card"
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"== device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.device("cuda", 0), smi


def phase_build(widths):
    """K1's library, the conv encoder's, and K2's and K3's at each (H, D) of
    ``widths``."""
    t0 = time.perf_counter()
    targets = [("affine_scan", ()), ("conv_encoder", ())]
    for H, D in widths:
        defines = (("SLODE_H", H), ("SLODE_D", D))
        targets += [("fused_semilinear_fwd", defines), ("fused_semilinear_bwd", defines)]
    logs = _build.build(targets)
    print(f"== build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s (into {_build.BUILD_DIR}) "
          f"({CARD['smi']})")
    for (name, defines), log in logs.items():
        print(f"-- nvcc -Xptxas -v: {name} {dict(defines)}\n{log.strip()}", flush=True)
        d = dict(defines)
        PTXAS[name, (d.get("SLODE_H"), d.get("SLODE_D"))] = ptxas_table(log)
    for (name, width), table in sorted(PTXAS.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        for (kernel, method), (regs, st, ld) in sorted(table.items()):
            print(f"registers {name} (H, D) = {width} {kernel} {method}: {regs} registers, spills {st} bytes "
                  f"stored / {ld} bytes loaded", flush=True)
    # the wrappers refuse widths before any build from a mirror of the
    # kernels' shared-memory layout: hold it to what each library reports
    for H, D in widths:
        for method in fused_step.METHODS:
            for backward, kernel in ((False, "K2"), (True, "K3")):
                mirror = fused_step.kernel_max_steps(H, D, method, backward)
                built = fused_step.library_max_steps(H, D, method, backward)
                check(built == mirror, f"{kernel} at (H, D) = ({H}, {D}) {method}: the library takes {built} steps "
                      f"a pass, ops/fused_step.py::kernel_max_steps says {mirror}")
        print(f"steps a pass (H, D) = ({H}, {D}): " + ", ".join(
            f"{m} K2 {fused_step.kernel_max_steps(H, D, m, False)} K3 {fused_step.kernel_max_steps(H, D, m, True)}"
            for m in fused_step.METHODS) + " (library = mirror)", flush=True)


def ptxas_table(log: str) -> dict:
    """{(kernel, method): (registers, spill stores, spill loads)} from one
    library's -Xptxas -v report; method is the tableau of a fused kernel's
    template argument (fused_step.METHODS order), else ''."""
    table, current, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"(fused_semilinear_(?:fwd|bwd)_kernel)ILi(\d+)E", name)
            plain = re.search(r"(affine_scan_(?:fwd|bwd)_kernel|reduce_partials|conv_pool_(?:fwd|wgrad)_kernel"
                              r"|conv_pool_wgrad_sum)", name)
            current = ((k.group(1), fused_step.METHODS[int(k.group(2))]) if k
                       else (plain.group(1) if plain else name, ""))
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            table[current] = (int(m.group(1)), *spills)
    return table


def ptxas_of(kernel: str, method: str, width) -> dict:
    """A fused kernel's registers and spills in the library of ``width``
    (empty in a rehearsal: nothing is built)."""
    name = "fused_semilinear_fwd" if kernel == "K2" else "fused_semilinear_bwd"
    got = PTXAS.get((name, tuple(width)), {}).get((name + "_kernel", method))
    return {} if got is None else {"registers": got[0], "spill_store_bytes": got[1], "spill_load_bytes": got[2]}


def _time(clock: Clock, rehearse: bool, key: str, call, plain, bound_ms, shape: str, plain_iters: int = 3,
          per_call: int = 1, iters: int = 20):
    """Kernel device time of a call (its ``per_call`` launches summed),
    wrapper call and plain version (CUDA events), beside the call's bound."""
    wrapper_ms = clock.ms(call, iters=iters)
    ms = wrapper_ms if rehearse else kernel_device_ms(key, call, iters=iters, per_call=per_call)
    plain_ms = clock.ms(plain, iters=plain_iters, warmup=1)
    bms, by = bound_ms
    each = f" ({ms / per_call:.4f} ms a launch, {per_call} launches)" if per_call > 1 else ""
    print(f"time {key} {shape}: kernel {ms:.4f} ms a call{each}, wrapper call {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}) ({CARD['smi']})", flush=True)
    return dict(shape=shape, ms=ms, ms_per_launch=ms / max(per_call, 1), wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)


def _k1_inputs(device, Bt, steps, D, seed):
    gen = torch.Generator().manual_seed(seed)
    A = torch.rand((Bt, steps, D), generator=gen) * 0.5 + 0.5
    B = (torch.rand((Bt, steps, D), generator=gen) - 0.5) * 0.2
    x0 = torch.rand((Bt, D), generator=gen) * 2 - 1
    g = torch.rand((Bt, steps + 1, D), generator=gen) - 0.5
    return A.to(device), B.to(device), x0.to(device), g.to(device)


def phase_kernels(device, clock: Clock, rehearse: bool, odes, H: int, D: int):
    """Each kernel against its plain version; returns per-kernel results.
    ``odes``: the ODE parameters of CVS (at ``H``, ``D``) and of each
    workload."""
    T = 86
    big_b = 64 if rehearse else BIG_B
    res = {k: {"err": 0.0, "worst": dict.fromkeys(TOLERANCE_RULES[k], 0.0)} for k in KERNELS}

    def held(key, name, out, ref, atol, rtol=0.0):
        res[key]["err"] = max(res[key]["err"], float((out - ref).abs().max()))
        r = ratio(out, ref, atol, rtol)
        res[key]["worst"][name] = max(res[key]["worst"][name], r)
        return r

    def k1_inputs(Bt, steps, D, seed):
        return _k1_inputs(device, Bt, steps, D, seed)

    def held_equal(key, name, out, ref):
        """Bit equality; the largest difference goes to the kernels line."""
        res[key]["err"] = max(res[key]["err"], float((out - ref).abs().max()) if out.numel() else 0.0)
        equal = torch.equal(out, ref)
        res[key]["worst"][name] = max(res[key]["worst"][name], 0.0 if equal else math.inf)
        return equal

    for Bt, steps, width in K1_SHAPES:
        Bt = min(Bt, big_b)
        A, B, x0, g = k1_inputs(Bt, steps, width, Bt * 1000 + steps * 10 + width)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        clock.sync()
        ref = recurrence.affine_scan_batched_plain(A, B, x0)
        ok = held_equal("K1", "xs", xs, ref)
        print(f"K1 affine_scan_fwd Bt={Bt} T={steps} D={width}: max_abs_err {float((xs - ref).abs().max()):.3e}, "
              f"bit-equal {ok}", flush=True)
        check(ok, f"K1 differs from its plain version at Bt={Bt} T={steps} D={width}")
        out = recurrence.affine_scan_bwd(A, xs, g)
        clock.sync()
        refs = recurrence.affine_scan_bwd_batched_plain(A, xs, g)
        ok = all([held_equal("K1-bwd", name, o, r) for name, o, r in zip(("dA", "dB", "dx0"), out, refs)])
        print(f"K1-bwd affine_scan_bwd Bt={Bt} T={steps} D={width}: max_abs_err "
              f"{max(float((o - r).abs().max()) for o, r in zip(out, refs)):.3e}, bit-equal {ok}", flush=True)
        check(ok, f"K1-bwd differs from its plain version at Bt={Bt} T={steps} D={width}")

    def k2_inputs(B, grid_name, steps_plus_one: int = T, ode=odes["cvs"]):
        return _fused_args(device, ode, B, steps_plus_one, grid_name)

    def k3_inputs(args, method):
        xs = fused_step.fused_semilinear_fwd(*args, method)
        g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device)
        return (*args[:6], xs, g, args[7])

    def check_fused(args, method, where, backward=True):
        """K2 and (unless not backward) K3 against their plain versions."""
        out = fused_step.fused_semilinear_fwd(*args, method)
        clock.sync()
        ref = fused_step.fused_semilinear_fwd_plain(*args, method)
        clock.sync()
        err = float((out - ref).abs().max())
        r = held("K2", "xs", out, ref, ATOL, RTOL)
        print(f"K2 fused_semilinear_fwd {method} {where}: max_abs_err {err:.3e} "
              f"max|x| {float(ref.abs().max()):.3g} (tol {ATOL:g} + {RTOL:g}*|x|)", flush=True)
        check(r <= 1.0, f"K2 disagrees with its plain version ({method}, {where})")
        if not backward:
            return
        bargs = k3_inputs(args, method)
        outs = fused_step.fused_semilinear_bwd(*bargs, method)
        clock.sync()
        refs = fused_step.fused_semilinear_bwd_plain(*bargs, method)
        clock.sync()
        # dx0 elementwise as K2; du elementwise with its absolute part scaled
        # by max|du| (DU_ATOL); each weight gradient against its leaf's
        # largest value
        worst = {}
        for name, o, r in zip(TOLERANCE_RULES["K3"], outs, refs):
            if name == "dx0":
                worst[name] = held("K3", name, o, r, ATOL, RTOL)
            elif name == "du":
                worst[name] = held("K3", name, o, r, DU_ATOL * float(r.abs().max()), RTOL)
                worst["du elementwise as K2"] = ratio(o, r, ATOL, RTOL)  # printed, not held
            else:
                worst[name] = held("K3", name, o, r, max(WGRAD_RTOL * float(r.abs().max()), 1e-30))
        print(f"K3 fused_semilinear_bwd {method} {where}: max_abs_err "
              f"{max(float((o - r).abs().max()) for o, r in zip(outs, refs)):.3e}; "
              f"error / tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()),
              flush=True)
        check(max(v for k, v in worst.items() if k != "du elementwise as K2") <= 1.0,
              f"K3 disagrees with its plain version ({method}, {where}): {worst}")

    with torch.inference_mode():
        for method in fused_step.METHODS:
            for B in (SERVE_B, TRAIN_B, big_b):
                for grid_name in ("uniform", "nonuniform"):
                    # the backward runs at the training shapes
                    check_fused(k2_inputs(B, grid_name), method, f"B={B} T={T} {grid_name}", backward=B != SERVE_B)
            # the edges of the kernels' layout (csrc/fused_semilinear.cuh): one
            # trajectory, two (one more than a block owns at a time), 130; one
            # step, the CVS grid, and 199 steps (two passes of up to 128 steps,
            # more steps than a block has threads)
            for B in (1, 2, 130):
                for steps_plus_one in (2, T, 200):
                    check_fused(k2_inputs(B, "nonuniform", steps_plus_one), method,
                                f"B={B} T={steps_plus_one} nonuniform")
            # each workload's training batch and val fold over its horizon,
            # at its own widths (proc's (25, 8) libraries; challenge's 141
            # steps, two passes)
            for wl, w in WORKLOADS.items():
                for B in (w["train_b"], w["val_b"]):
                    check_fused(k2_inputs(B, "uniform", w["T"], odes[wl]), method,
                                f"{wl} B={B} T={w['T']} D={w['D']} uniform")

    # times at the serving, training and large shapes; midpoint for K2 and K3
    S = 2
    for label, Bt in (("serve", SERVE_B), ("train", TRAIN_B), ("big", big_b)):
        A, B, x0, g = k1_inputs(Bt, T - 1, D, 1)
        shape = f"Bt={Bt} T={T - 1} D={D}"
        res["K1"][label] = _time(clock, rehearse, "K1", lambda: recurrence.affine_scan_fwd(A, B, x0),
                                 lambda: recurrence.affine_scan_batched_plain(A, B, x0),
                                 k1_bound_ms(T - 1, Bt * D), shape)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        res["K1-bwd"][label] = _time(clock, rehearse, "K1-bwd", lambda: recurrence.affine_scan_bwd(A, xs, g),
                                     lambda: recurrence.affine_scan_bwd_batched_plain(A, xs, g),
                                     k1_bwd_bound_ms(T - 1, Bt * D), shape)
    # the whole batch-major entry as the model calls it (the autograd node
    # included): forward alone (serving) and forward plus backward (training)
    A, B, x0, g = k1_inputs(TRAIN_B, T - 1, D, 1)
    leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
    with torch.inference_mode():
        fwd_ms = clock.ms(lambda: recurrence.affine_scan(A, B, x0), iters=20)
    both_ms = clock.ms(lambda: torch.autograd.grad(recurrence.affine_scan(*leaves), leaves, g), iters=20)
    res["K1"]["affine_scan_call"] = {"shape": f"Bt={TRAIN_B} T={T - 1} D={D}", "forward_ms": fwd_ms,
                                     "forward_backward_ms": both_ms}
    print(f"time affine_scan call Bt={TRAIN_B} T={T - 1} D={D}: forward {fwd_ms:.4f} ms, "
          f"forward + backward {both_ms:.4f} ms ({CARD['smi']})", flush=True)
    with torch.inference_mode():
        for label, B in (("serve", SERVE_B), ("train", TRAIN_B), ("big", big_b)):
            args = k2_inputs(B, "uniform")
            res["K2"][label] = _time(clock, rehearse, "K2", lambda: fused_step.fused_semilinear_fwd(*args, "midpoint"),
                                     lambda: fused_step.fused_semilinear_fwd_plain(*args, "midpoint"),
                                     k2_bound_ms(B, T, S, H, D), f"midpoint B={B} T={T} H={H} D={D}")
            if label == "serve":
                continue
            bargs = k3_inputs(args, "midpoint")
            res["K3"][label] = _time(clock, rehearse, "K3", lambda: fused_step.fused_semilinear_bwd(*bargs, "midpoint"),
                                     lambda: fused_step.fused_semilinear_bwd_plain(*bargs, "midpoint"),
                                     k3_bound_ms(B, T, S, H, D), f"midpoint B={B} T={T} H={H} D={D}")
    # each workload's training shape
    for wl, w in WORKLOADS.items():
        label, Bt, steps, width = f"{wl}_train", w["train_b"], w["T"] - 1, w["D"]
        A, B, x0, g = k1_inputs(Bt, steps, width, 1)
        shape = f"Bt={Bt} T={steps} D={width}"
        res["K1"][label] = _time(clock, rehearse, "K1", lambda: recurrence.affine_scan_fwd(A, B, x0),
                                 lambda: recurrence.affine_scan_batched_plain(A, B, x0),
                                 k1_bound_ms(steps, Bt * width), shape)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        res["K1-bwd"][label] = _time(clock, rehearse, "K1-bwd", lambda: recurrence.affine_scan_bwd(A, xs, g),
                                     lambda: recurrence.affine_scan_bwd_batched_plain(A, xs, g),
                                     k1_bwd_bound_ms(steps, Bt * width), shape)
        with torch.inference_mode():
            args = k2_inputs(Bt, "uniform", w["T"], odes[wl])
            Hw = args[0].shape[1]
            shape = f"midpoint B={Bt} T={w['T']} H={Hw} D={width}"
            res["K2"][label] = _time(clock, rehearse, "K2", lambda: fused_step.fused_semilinear_fwd(*args, "midpoint"),
                                     lambda: fused_step.fused_semilinear_fwd_plain(*args, "midpoint"),
                                     k2_bound_ms(Bt, w["T"], S, Hw, width), shape)
            bargs = k3_inputs(args, "midpoint")
            res["K3"][label] = _time(clock, rehearse, "K3", lambda: fused_step.fused_semilinear_bwd(*bargs, "midpoint"),
                                     lambda: fused_step.fused_semilinear_bwd_plain(*bargs, "midpoint"),
                                     k3_bound_ms(Bt, w["T"], S, Hw, width), shape)
    return res


def phase_long_horizon(device, clock: Clock, rehearse: bool, smi: str, res: dict, paths: dict):
    """C1: K1 and K1-bwd through the model's entry past their shared-memory
    cap, at T = 4096 with D = 5 and D = 8: the time axis split into runs,
    bit for bit the plain versions; the split's launches and times; then one
    training step of the decoder ODE on semilinear at that horizon and
    width."""
    T = 60 if rehearse else LONG_T
    Bt = 4 if rehearse else TRAIN_B
    for D in (5, 8):
        A, B, x0, g = _k1_inputs(device, Bt, T, D, 7 + D)
        leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
        fwd0, bwd0 = recurrence.affine_scan_fwd.launches, recurrence.affine_scan_bwd.launches
        xs = recurrence.affine_scan(*leaves)
        n_fwd = recurrence.affine_scan_fwd.launches - fwd0
        grads = torch.autograd.grad(xs, leaves, g)
        n_bwd = recurrence.affine_scan_bwd.launches - bwd0
        clock.sync()
        ref = recurrence.affine_scan_batched_plain(A, B, x0)
        refs = recurrence.affine_scan_bwd_batched_plain(A, ref, g)
        clock.sync()
        ok = torch.equal(xs.detach(), ref) and all(torch.equal(o, r) for o, r in zip(grads, refs))
        check(ok, f"C1: the split K1/K1-bwd differ from their plain versions at Bt={Bt} T={T} D={D}")
        check(rehearse or (n_fwd > 1 and n_bwd > 1), f"C1: T={T} D={D} made {n_fwd}/{n_bwd} launches, not a split")
        xs = xs.detach()
        shape = f"Bt={Bt} T={T} D={D}, {n_fwd} runs forward, {n_bwd} backward"
        res["K1"][f"c1_D{D}"] = _time(clock, rehearse, "K1", lambda: recurrence.affine_scan(A, B, x0),
                                      lambda: recurrence.affine_scan_batched_plain(A, B, x0),
                                      k1_bound_ms(T, Bt * D), shape, plain_iters=1, per_call=n_fwd, iters=5)
        res["K1-bwd"][f"c1_D{D}"] = _time(clock, rehearse, "K1-bwd", lambda: recurrence._scan_bwd(A, xs, g),
                                          lambda: recurrence.affine_scan_bwd_batched_plain(A, xs, g),
                                          k1_bwd_bound_ms(T, Bt * D), shape, plain_iters=1, per_call=n_bwd,
                                          iters=5)
        for key in ("K1", "K1-bwd"):
            res[key][f"c1_D{D}"].update(launches_per_call=n_fwd if key == "K1" else n_bwd, bit_equal=ok)
        print(f"C1 K1/K1-bwd Bt={Bt} T={T} D={D}: bit-equal {ok}, {n_fwd} launches forward, {n_bwd} backward "
              f"({smi})", flush=True)

        # a training step of the decoder ODE at this horizon and width on
        # semilinear (the JAX package's long-horizon grad step,
        # scripts/bench_longhorizon.py): the squared error of the solve
        # against a target, its gradient through K1/K1-bwd, one Adam update.
        # (The whole CVS model at T = 4096 would spend minutes on the host
        # in its encoder's orthogonal init, a QR of a 40,840-square matrix.)
        spec = OdeModelSpec(latent_dim=15, ode_state_dim=D, ode_hidden_dim=25, backend="semilinear")
        gen = torch.Generator().manual_seed(D)
        params = tree_map(lambda p: p.to(device), ode_model_init(gen, spec))
        n = 4 if rehearse else 16
        z = torch.randn((n, 15), generator=gen).to(device)
        target = torch.rand((n, T + 1, D), generator=gen).to(device)
        ts = torch.arange(float(T + 1), device=device)

        def step():
            loss, _, grads = svi.value_and_grad(lambda p: ((solve_ode(spec, p, z, ts) - target) ** 2).mean(), params)
            new, _ = svi.shared_adam_update(grads, svi.shared_adam_init(params), params,
                                            tree_map(lambda _: True, params), 1e-3)
            return loss, new

        t0 = time.perf_counter()
        loss, new = counted(paths, f"train step T={T} D={D}", TRAINING["semilinear"], rehearse, step)
        clock.sync()
        ms = (time.perf_counter() - t0) * 1e3
        check(math.isfinite(float(loss)) and all(torch.isfinite(p).all() for p in tree_leaves(new)),
              f"C1: non-finite training step at T={T} D={D}")
        print(f"C1 training step of the decoder ODE, semilinear, T={T} D={D} B={n}: loss {float(loss):.6f}; "
              f"launches {paths[f'train step T={T} D={D}']}; {ms:.1f} ms first call ({smi})", flush=True)


def _member_args(device, spec, S: int, B: int, T: int):
    """S members' K2 arguments at one shape: each member its own ODE
    weights (init seeds 0..S-1) and latents, stacked; one time grid."""
    per = []
    for m in range(S):
        ode = init_params(spec, m, device=device)["decoder"]["ode"]
        z = torch.randn((B, spec.latent_dim), generator=torch.Generator().manual_seed(10 + m)).to(device)
        W = ode["dyn_hidden"]["W"]
        u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
        per.append((u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
                    initialize_state(ode, z)))
    return tuple(torch.stack([p[i] for p in per]) for i in range(7)) + (torch.arange(float(T), device=device),)


def phase_members(device, clock: Clock, rehearse: bool, smi: str, res: dict):
    """The member-batched K2 and K3 at the CVS sweep's and the proc sweep's
    shapes (midpoint): each member bit for bit a single-member launch on its
    slices (the weight gradients included), and within K2's and K3's
    tolerances of the plain versions; then timed beside their plain versions,
    the bound at S*B and S single-member launches of the same work."""
    specs = {"cvs": cvs_spec(load_cvs_config()), "proc": proc_spec(LOADERS["proc"](), n_time=100)}
    for wl, (S, B, T) in MEMBER_SHAPES.items():
        if rehearse:
            S, B = 2, 4
        spec = specs[wl]
        H, D = spec.decoder.ode.ode_hidden_dim, spec.decoder.ode.ode_state_dim
        with torch.inference_mode():
            args = _member_args(device, spec, S, B, T)
            xs = fused_step.fused_semilinear_fwd_members(*args, "midpoint")
            g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device)
            bargs = (*args[:6], xs, g, args[7])
            outs = fused_step.fused_semilinear_bwd_members(*bargs, "midpoint")
            clock.sync()
            singles_ok = True
            for m in range(S):
                one = tuple(a[m] for a in args[:7]) + (args[7],)
                same = torch.equal(xs[m], fused_step.fused_semilinear_fwd(*one, "midpoint"))
                single = fused_step.fused_semilinear_bwd(*one[:6], xs[m], g[m], args[7], "midpoint")
                same_b = all(torch.equal(o[m], r) for o, r in zip(outs, single))
                singles_ok &= same and same_b
                for key, ok in (("K2-members", same), ("K3-members", same_b)):
                    res[key]["worst"]["single-member launch"] = max(
                        res[key]["worst"]["single-member launch"], 0.0 if ok else math.inf)
                ref = fused_step.fused_semilinear_fwd_plain(*one, "midpoint")
                refs = fused_step.fused_semilinear_bwd_plain(*one[:6], xs[m], g[m], args[7], "midpoint")
                worst = {"xs": ratio(xs[m], ref, ATOL, RTOL)}
                for name, o, r in zip(TOLERANCE_RULES["K3"], outs, refs):
                    o = o[m]
                    if name == "dx0":
                        worst[name] = ratio(o, r, ATOL, RTOL)
                    elif name == "du":
                        worst[name] = ratio(o, r, DU_ATOL * float(r.abs().max()), RTOL)
                    else:
                        worst[name] = ratio(o, r, max(WGRAD_RTOL * float(r.abs().max()), 1e-30))
                    res["K3-members"]["err"] = max(res["K3-members"]["err"], float((o - r).abs().max()))
                    res["K3-members"]["worst"][name] = max(res["K3-members"]["worst"][name], worst[name])
                res["K2-members"]["err"] = max(res["K2-members"]["err"], float((xs[m] - ref).abs().max()))
                res["K2-members"]["worst"]["xs"] = max(res["K2-members"]["worst"]["xs"], worst["xs"])
                check(max(worst.values()) <= 1.0, f"member-batched K2/K3 {wl} member {m}: {worst}")
            print(f"member-batched K2/K3 {wl} S={S} B={B} T={T} H={H} D={D}: every member bit-equal to its "
                  f"single-member launch {singles_ok}; worst error / tolerance vs plain "
                  f"K2 {res['K2-members']['worst']['xs']:.3f}, K3 "
                  f"{max(v for k, v in res['K3-members']['worst'].items() if k != 'single-member launch'):.3f}",
                  flush=True)
            check(singles_ok, f"member-batched K2/K3 {wl}: a member differs from its single-member launch")
            shape = f"midpoint S={S} B={B} T={T} H={H} D={D}"
            res["K2-members"][wl] = _time(
                clock, rehearse, "K2-members", lambda: fused_step.fused_semilinear_fwd_members(*args, "midpoint"),
                lambda: fused_step.fused_semilinear_fwd_members_plain(*args, "midpoint"),
                k2_bound_ms(S * B, T, 2, H, D, members=S), shape, plain_iters=1)
            res["K3-members"][wl] = _time(
                clock, rehearse, "K3-members", lambda: fused_step.fused_semilinear_bwd_members(*bargs, "midpoint"),
                lambda: fused_step.fused_semilinear_bwd_members_plain(*bargs, "midpoint"),
                k3_bound_ms(S * B, T, 2, H, D, members=S), shape, plain_iters=1)
            # the same work as S single-member launches, wrapper calls timed
            ones = [tuple(a[m] for a in args[:7]) + (args[7],) for m in range(S)]
            res["K2-members"][wl]["s_single_calls_ms"] = clock.ms(
                lambda: [fused_step.fused_semilinear_fwd(*one, "midpoint") for one in ones], iters=10)
            res["K3-members"][wl]["s_single_calls_ms"] = clock.ms(
                lambda: [fused_step.fused_semilinear_bwd(*one[:6], xs[m], g[m], one[7], "midpoint")
                         for m, one in enumerate(ones)], iters=10)
            for key in ("K2-members", "K3-members"):
                print(f"time {key} {shape}: {S} single-member wrapper calls "
                      f"{res[key][wl]['s_single_calls_ms']:.4f} ms against one member-batched wrapper call "
                      f"{res[key][wl]['wrapper_ms']:.4f} ms ({smi})", flush=True)


def conv_bound_ms(S: int, B: int, enc):
    """(forward, weight gradient) bounds of the conv encoder's calls at ``S``
    members (0: one model) of ``B`` trajectories through encoder ``enc``:
    each input read and each output written once; the forward's products,
    bias and pool sums, the weight gradient's pool backward, products and
    bias sums."""
    traj = max(S, 1) * B
    K, T, Fn, W, P = enc.n_channels, enc.n_time, enc.n_filters, enc.filter_size, enc.pool_size
    params = max(S, 1) * (Fn * K * W + Fn)
    products = 2 * Fn * K * W * enc.n_conv
    fwd = bound(4 * (traj * K * T + params + traj * Fn * enc.n_pool),
                traj * (products + Fn * enc.n_conv + Fn * enc.n_pool * P))
    wgrad = bound(4 * (traj * K * T + traj * Fn * enc.n_pool + params),
                  traj * (products + Fn * enc.n_conv + Fn * enc.n_conv * P))
    return fwd, wgrad


def _conv_library(x, w, b, g, pool: int, members: bool):
    """cuDNN's way of the conv kernels' work, as the port ran the encoder
    before them: the forward (F.conv1d, F.avg_pool1d, flatten; for members
    under torch.func.vmap, a grouped convolution), and from its autograd
    graph the weight and bias gradients (the pool's backward and cuDNN's
    weight gradient), as callables."""
    def fwd(x, w, b):
        return conv_encoder.conv_pool_fwd_plain(x, w, b, pool)

    forward = torch.func.vmap(fwd) if members else fwd
    w, b = w.detach().requires_grad_(), b.detach().requires_grad_()
    y = forward(x, w, b)
    return (lambda: forward(x, w, b)), (lambda: torch.autograd.grad(y, (w, b), g, retain_graph=True))


def phase_conv(device, clock: Clock, rehearse: bool, smi: str, res: dict):
    """The conv encoder's kernels at each workload's encoder (CONV_SHAPES):
    the forward and the weight gradient against their plain versions in
    float64 on the host, a second launch bit for bit the first, and each
    member of the member-batched launches bit for bit a single-member launch
    on its slices, with its own observations and with one set for all
    members passed as an expand (the val ELBO's); then each timed beside
    its plain version, its bound and cuDNN's way of the same work
    (deterministic, TF32 off, as the port trained before these kernels)."""
    encs = {"cvs": cvs_spec(load_cvs_config()).encoder,
            **{wl: w["spec"](LOADERS[wl](), n_time=w["T"]).encoder for wl, w in WORKLOADS.items()}}
    for label, (S, B) in CONV_SHAPES.items():
        enc = encs[label.split("_")[0]]
        if rehearse:
            S, B = min(S, 2), 4
        K, T, Fn, W, P = enc.n_channels, enc.n_time, enc.n_filters, enc.filter_size, enc.pool_size
        fwd_key, wgrad_key = ("conv_pool_fwd_members", "conv_pool_wgrad_members") if S else ENCODE_TRAIN
        fwd, wgrad = KERNELS[fwd_key], KERNELS[wgrad_key]
        fwd_plain, wgrad_plain = getattr(conv_encoder, fwd_key + "_plain"), getattr(conv_encoder, wgrad_key + "_plain")
        gen = torch.Generator().manual_seed(1000 * S + B)
        lead = (S,) if S else ()
        x = torch.rand(lead + (B, K, T), generator=gen)
        w = (torch.rand(lead + (Fn, K, W), generator=gen) - 0.5) * 0.4
        b = torch.rand(lead + (Fn,), generator=gen) - 0.5
        g = torch.randn(lead + (B, Fn * enc.n_pool), generator=gen)
        refs = {"y": fwd_plain(x.double(), w.double(), b.double(), P)}
        refs["dw"], refs["db"] = wgrad_plain(x.double(), g.double(), W, P)
        x, w, b, g = (t.to(device) for t in (x, w, b, g))
        with torch.inference_mode():
            outs = {"y": fwd(x, w, b, P)}
            outs["dw"], outs["db"] = wgrad(x, g, W, P)
            again = {"y": fwd(x, w, b, P)}
            again["dw"], again["db"] = wgrad(x, g, W, P)
            clock.sync()
            worst = {}
            for name, out in outs.items():
                key, ref = (fwd_key if name == "y" else wgrad_key), refs[name]
                out = out.cpu().double()
                tol = (ATOL, RTOL) if name == "y" else (max(WGRAD_RTOL * float(ref.abs().max()), 1e-30), 0.0)
                worst[name] = ratio(out, ref, *tol)
                res[key]["err"] = max(res[key]["err"], float((out - ref).abs().max()))
                res[key]["worst"][name] = max(res[key]["worst"][name], worst[name])
            repeat = {fwd_key: torch.equal(outs["y"], again["y"]),
                      wgrad_key: all(torch.equal(outs[n], again[n]) for n in ("dw", "db"))}
            singles = {fwd_key: True, wgrad_key: True}
            for shared in ((False, True) if S else ()):
                xs = x[0].expand(x.shape) if shared else x
                y = fwd(xs, w, b, P)
                dw, db = wgrad(xs, g, W, P)
                for s in range(S):
                    one_dw, one_db = conv_encoder.conv_pool_wgrad(xs[s], g[s], W, P)
                    singles[fwd_key] &= torch.equal(y[s], conv_encoder.conv_pool_fwd(xs[s], w[s], b[s], P))
                    singles[wgrad_key] &= torch.equal(dw[s], one_dw) and torch.equal(db[s], one_db)
            for key in (fwd_key, wgrad_key):
                res[key]["worst"]["repeat"] = max(res[key]["worst"]["repeat"], 0.0 if repeat[key] else math.inf)
                if S:
                    res[key]["worst"]["single-member launch"] = max(res[key]["worst"]["single-member launch"],
                                                                    0.0 if singles[key] else math.inf)
        shape = f"S={S} B={B} K={K} T={T} F={Fn} W={W} pool={P}"
        print(f"conv encoder {label} {shape}: worst error / tolerance vs plain (float64) " +
              ", ".join(f"{k} {v:.3f}" for k, v in worst.items()) + f"; a second launch bit for bit {repeat}" +
              (f"; every member bit for bit its single-member launch (own and shared observations) {singles}"
               if S else ""), flush=True)
        check(max(worst.values()) <= 1.0, f"conv encoder {label}: disagrees with its plain version: {worst}")
        check(all(repeat.values()), f"conv encoder {label}: a second launch differs from the first: {repeat}")
        check(all(singles.values()), f"conv encoder {label}: a member differs from its single-member launch")
        fwd_bound, wgrad_bound = conv_bound_ms(S, B, enc)
        plain_iters = 1 if S else 3
        res[fwd_key][label] = _time(clock, rehearse, fwd_key, lambda: fwd(x, w, b, P),
                                    lambda: fwd_plain(x, w, b, P), fwd_bound, shape, plain_iters=plain_iters)
        res[wgrad_key][label] = _time(clock, rehearse, wgrad_key, lambda: wgrad(x, g, W, P),
                                      lambda: wgrad_plain(x, g, W, P), wgrad_bound, shape, plain_iters=plain_iters)
        full_fp32(deterministic=True)
        lib_fwd, lib_wgrad = _conv_library(x, w, b, g, P, bool(S))
        res[fwd_key][label]["library_ms"] = clock.ms(lib_fwd, iters=20)
        res[wgrad_key][label]["library_ms"] = clock.ms(lib_wgrad, iters=20)
        full_fp32()
        print(f"time conv encoder {label} {shape}: cuDNN's way (deterministic, TF32 off) forward "
              f"{res[fwd_key][label]['library_ms']:.4f} ms, weight and bias gradients "
              f"{res[wgrad_key][label]['library_ms']:.4f} ms ({smi})", flush=True)


def _width_ode(device, H: int, D: int, L: int = 15):
    """Random ODE weights at (H, D) (the port's init, seed H + D)."""
    spec = OdeModelSpec(latent_dim=L, ode_state_dim=D, ode_hidden_dim=H)
    return tree_map(lambda p: p.to(device), ode_model_init(torch.Generator().manual_seed(H + D), spec))


def _fused_args(device, ode, B: int, T: int, grid: str = "uniform", seed: int = 0):
    """K2's arguments for ``ode`` at B trajectories over T times."""
    z = torch.randn((B, ode["latent_to_ode"][0]["W"].shape[1]), generator=torch.Generator().manual_seed(seed + B))
    z = z.to(device)
    W = ode["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
    ts = (torch.arange(float(T)) if grid == "uniform" else torch.tensor(
        np.cumsum(np.abs(np.random.RandomState(0).randn(T)) * 0.2 + 0.05), dtype=torch.float32)).to(device)
    return (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
            initialize_state(ode, z), ts)


def _k3_worst(outs, refs, m=None) -> dict:
    """K3's outputs against the plain version's, each under its rule of
    TOLERANCE_RULES["K3"] (member ``m`` of member-batched outputs)."""
    worst = {}
    for name, o, r in zip(TOLERANCE_RULES["K3"], outs, refs):
        o = o if m is None else o[m]
        if name == "dx0":
            worst[name] = ratio(o, r, ATOL, RTOL)
        elif name == "du":
            worst[name] = ratio(o, r, DU_ATOL * float(r.abs().max()), RTOL)
        else:
            worst[name] = ratio(o, r, max(WGRAD_RTOL * float(r.abs().max()), 1e-30))
    return worst


def phase_c2(device, clock: Clock, rehearse: bool, smi: str, odes: dict):
    """C2: K2 and K3 at dopri5 (seven stages) at CVS's (25, 5) and proc's
    (25, 8), and at midpoint past one warp's lanes, (H, D) = (40, 17) and
    (128, 32) (more than one pass of K3 where its shared memory shortens the
    pass), against their plain versions at K2's and K3's tolerances (at the
    training shape and, for the wide widths, at B = 3 over 200 times); then
    each timed (kernel, wrapper call, plain version) beside its bound and its
    -Xptxas -v registers and spills; and one member-batched dopri5 launch at
    the proc sweep's S = 5: each member bit for bit its single-member launch,
    within the tolerances of the plain version. Returns the records by case."""
    cases = [("dopri5 cvs", "dopri5", odes["cvs"], TRAIN_B, 86), ("dopri5 proc", "dopri5", odes["proc"], 36, 100)]
    cases += [(f"wide {H}x{D}", "midpoint", _width_ode(device, H, D), TRAIN_B, 86) for H, D in WIDE]
    out = {}
    for case, method, ode, B, T in cases:
        if rehearse:
            B = 4
        H, D = ode["dyn_hidden"]["W"].shape[0], ode["prod"]["W"].shape[0]
        S = len(fused_step.get_tableau(method).c)
        rec = {"K2": {"err": 0.0, "worst": {}}, "K3": {"err": 0.0, "worst": {}}}
        shapes = [(B, T, "uniform")] + ([(3, 200, "nonuniform")] if case.startswith("wide") else [])
        with torch.inference_mode():
            for b, t, grid in shapes:
                args = _fused_args(device, ode, b, t, grid)
                xs = fused_step.fused_semilinear_fwd(*args, method)
                clock.sync()
                ref = fused_step.fused_semilinear_fwd_plain(*args, method)
                g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device)
                bargs = (*args[:6], xs, g, args[7])
                outs = fused_step.fused_semilinear_bwd(*bargs, method)
                clock.sync()
                refs = fused_step.fused_semilinear_bwd_plain(*bargs, method)
                w2 = ratio(xs, ref, ATOL, RTOL)
                w3 = _k3_worst(outs, refs)
                rec["K2"]["err"] = max(rec["K2"]["err"], float((xs - ref).abs().max()))
                rec["K3"]["err"] = max(rec["K3"]["err"], max(float((o - r).abs().max()) for o, r in zip(outs, refs)))
                rec["K2"]["worst"]["xs"] = max(rec["K2"]["worst"].get("xs", 0.0), w2)
                for k, v in w3.items():
                    rec["K3"]["worst"][k] = max(rec["K3"]["worst"].get(k, 0.0), v)
                print(f"C2 {case} {method} B={b} T={t} H={H} D={D} {grid}: K2 error / tolerance {w2:.3f}; K3 "
                      + ", ".join(f"{k} {v:.3f}" for k, v in w3.items()), flush=True)
                check(w2 <= 1.0 and max(w3.values()) <= 1.0, f"C2 {case}: K2/K3 disagree with their plain versions")
            args = _fused_args(device, ode, B, T)
            shape = f"{method} B={B} T={T} H={H} D={D}"
            rec["K2"].update(_time(clock, rehearse, "K2", lambda: fused_step.fused_semilinear_fwd(*args, method),
                                   lambda: fused_step.fused_semilinear_fwd_plain(*args, method),
                                   k2_bound_ms(B, T, S, H, D), shape, plain_iters=1))
            xs = fused_step.fused_semilinear_fwd(*args, method)
            bargs = (*args[:6], xs, torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device),
                     args[7])
            rec["K3"].update(_time(clock, rehearse, "K3", lambda: fused_step.fused_semilinear_bwd(*bargs, method),
                                   lambda: fused_step.fused_semilinear_bwd_plain(*bargs, method),
                                   k3_bound_ms(B, T, S, H, D), shape, plain_iters=1))
        for key in ("K2", "K3"):
            rec[key].update(method=method, width=[H, D], ptxas=ptxas_of(key, method, (H, D)),
                            passes_of=fused_step.kernel_max_steps(H, D, method, key == "K3"))
            print(f"C2 {case} {key}: registers and spills {rec[key]['ptxas']}, passes of at most "
                  f"{rec[key]['passes_of']} steps ({smi})", flush=True)
        out[case] = rec

    # one member-batched dopri5 launch at the proc sweep's shape
    spec = proc_spec(LOADERS["proc"](), n_time=100)
    S_m, B_m, T_m = (2, 4, 100) if rehearse else MEMBER_SHAPES["proc"]
    rec = {"K2-members": {"err": 0.0, "worst": {}}, "K3-members": {"err": 0.0, "worst": {}}}
    with torch.inference_mode():
        args = _member_args(device, spec, S_m, B_m, T_m)
        xs = fused_step.fused_semilinear_fwd_members(*args, "dopri5")
        g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device)
        bargs = (*args[:6], xs, g, args[7])
        outs = fused_step.fused_semilinear_bwd_members(*bargs, "dopri5")
        clock.sync()
        same = True
        for m in range(S_m):
            one = tuple(a[m] for a in args[:7]) + (args[7],)
            same &= torch.equal(xs[m], fused_step.fused_semilinear_fwd(*one, "dopri5"))
            single = fused_step.fused_semilinear_bwd(*one[:6], xs[m], g[m], args[7], "dopri5")
            same &= all(torch.equal(o[m], r) for o, r in zip(outs, single))
            ref = fused_step.fused_semilinear_fwd_plain(*one, "dopri5")
            refs = fused_step.fused_semilinear_bwd_plain(*one[:6], xs[m], g[m], args[7], "dopri5")
            w2, w3 = ratio(xs[m], ref, ATOL, RTOL), _k3_worst(outs, refs, m)
            rec["K2-members"]["err"] = max(rec["K2-members"]["err"], float((xs[m] - ref).abs().max()))
            rec["K3-members"]["err"] = max(rec["K3-members"]["err"],
                                           max(float((o[m] - r).abs().max()) for o, r in zip(outs, refs)))
            rec["K2-members"]["worst"]["xs"] = max(rec["K2-members"]["worst"].get("xs", 0.0), w2)
            for k, v in w3.items():
                rec["K3-members"]["worst"][k] = max(rec["K3-members"]["worst"].get(k, 0.0), v)
            check(w2 <= 1.0 and max(w3.values()) <= 1.0, f"C2 member-batched dopri5 member {m}: {w2}, {w3}")
        for key in rec:
            rec[key]["worst"]["single-member launch"] = 0.0 if same else math.inf
        print(f"C2 member-batched dopri5 S={S_m} B={B_m} T={T_m}: every member bit-equal to its single-member "
              f"launch {same}; worst error / tolerance K2 {rec['K2-members']['worst']['xs']:.3f}, K3 "
              f"{max(v for k, v in rec['K3-members']['worst'].items() if k != 'single-member launch'):.3f}",
              flush=True)
        check(same, "C2 member-batched dopri5: a member differs from its single-member launch")
        shape = f"dopri5 S={S_m} B={B_m} T={T_m} H=25 D=8"
        rec["K2-members"].update(_time(
            clock, rehearse, "K2-members", lambda: fused_step.fused_semilinear_fwd_members(*args, "dopri5"),
            lambda: fused_step.fused_semilinear_fwd_members_plain(*args, "dopri5"),
            k2_bound_ms(S_m * B_m, T_m, 7, 25, 8, members=S_m), shape, plain_iters=1))
        rec["K3-members"].update(_time(
            clock, rehearse, "K3-members", lambda: fused_step.fused_semilinear_bwd_members(*bargs, "dopri5"),
            lambda: fused_step.fused_semilinear_bwd_members_plain(*bargs, "dopri5"),
            k3_bound_ms(S_m * B_m, T_m, 7, 25, 8, members=S_m), shape, plain_iters=1))
    for key in rec:
        rec[key].update(method="dopri5", width=[25, 8], ptxas=ptxas_of(key[:2], "dopri5", (25, 8)))
    out["dopri5 proc members"] = rec
    return out


def _decoder_step(device, spec: OdeModelSpec, B: int, T: int, seed: int):
    """One training step of the decoder ODE alone (the squared error of its
    solve against a target, the gradient, an Adam update) and one forward
    solve, as C1's: the model around it has no config at these widths."""
    gen = torch.Generator().manual_seed(seed)
    params = tree_map(lambda p: p.to(device), ode_model_init(gen, spec))
    z = torch.randn((B, spec.latent_dim), generator=gen).to(device)
    target = torch.rand((B, T, spec.ode_state_dim), generator=gen).to(device)
    ts = torch.arange(float(T), device=device)
    with torch.inference_mode():
        served = solve_ode(spec, params, z, ts)
    loss, _, grads = svi.value_and_grad(lambda p: ((solve_ode(spec, p, z, ts) - target) ** 2).mean(), params)
    new, _ = svi.shared_adam_update(grads, svi.shared_adam_init(params), params, tree_map(lambda _: True, params),
                                    1e-3)
    check(torch.isfinite(served).all() and math.isfinite(float(loss))
          and all(torch.isfinite(p).all() for p in tree_leaves(new)), f"decoder ODE step {spec}: non-finite")
    return float(loss)


def phase_c2_paths(device, data_dir: str, rehearse: bool, smi: str, paths: dict):
    """The paths that launch C2's kernels, each counted: CVS on
    semilinear_auto at dopri5 (a served request and a dual step: K2/K3 at
    (25, 5)), proc's dual step there (K2/K3 at (25, 8)), the proc sweep's
    stacked dual step at S = 5 on semilinear_fused at dopri5 (the
    member-batched K2/K3), and the decoder ODE's training step at each wide
    width on semilinear_fused (K2/K3 at (40, 17) and (128, 32))."""
    ts = torch.arange(86.0, device=device)
    cfg = _config(data_dir, "semilinear_auto")
    cfg.solver = "dopri5"
    spec = cvs_spec(cfg)
    splits = training_cvs.build_splits(cfg, device=device)[0]
    params = init_params(spec, 0, device=device)
    recon_fn, _ = serve.make_predict_fns(spec, np.arange(86.0, dtype=np.float32), device)
    test = {k: torch.as_tensor(v, device=device) for k, v in splits["test"].items()}
    test["sample_id"] = torch.arange(test["observations"].shape[0], device=device)
    train = {k: v[0] for k, v in device_batch(stacked_minibatches(splits["train"], TRAIN_B, shuffle=False),
                                               device).items()}

    def cvs_path():
        recon_fn(params, 0, test, True)
        init_state, train_step, _ = svi.make_train_step(spec, ts, cfg.learning_rate, params)
        train_step(init_state(params, 0), train)

    counted(paths, "c2 cvs dopri5 semilinear_auto", ("K2", "K3"), rehearse, cvs_path)
    pcfg = _workload_config("proc", "semilinear_auto")
    pcfg.solver = "dopri5"
    pspec = proc_spec(pcfg, n_time=100)
    _, psplits, ptimes = serve._build("proc", pcfg, device)
    pbatch = {k: v[0] for k, v in device_batch(stacked_minibatches(psplits["train"], 36, shuffle=False),
                                                device).items()}
    pts = torch.as_tensor(ptimes, device=device)
    pparams = init_params(pspec, 0, device=device)

    def proc_path():
        init_state, train_step, _ = svi.make_train_step(pspec, pts, pcfg.learning_rate, pparams)
        train_step(init_state(pparams, 0), pbatch)

    counted(paths, "c2 proc dopri5 semilinear_auto", ("K2", "K3"), rehearse, proc_path)
    fcfg = _workload_config("proc", "semilinear_fused")
    fcfg.solver = "dopri5"
    fspec = proc_spec(fcfg, n_time=100)
    S = 2 if rehearse else MEMBER_SHAPES["proc"][0]
    members = [init_params(fspec, fold_seed(12 + m, "init"), device=device) for m in range(S)]
    optim = svi.make_dual_optimizer(fspec, members[0], fcfg.learning_rate)
    state = ensemble.stack_states([svi.SVIState(p, optim.init(p), fold_seed(12 + m, "train"), 0)
                                   for m, p in enumerate(members)])
    stacked = {k: v.expand(S, *v.shape).contiguous() for k, v in pbatch.items() if k != "mask"}
    stacked["mask"] = pbatch["mask"]
    dims = {k: 0 for k in stacked}
    dims["mask"] = None
    step = svi.make_stacked_dual_step(fspec, pts, optim)
    seeds = svi.stacked_step_seeds(state.seed, range(1), device=device)
    counted(paths, "c2 proc stacked S=5 dopri5 semilinear_fused", ("K2-members", "K3-members"), rehearse,
            lambda: step(state, stacked, dims, seeds[0]))
    for H, D in WIDE:
        wspec = OdeModelSpec(latent_dim=15, ode_state_dim=D, ode_hidden_dim=H, backend="semilinear_fused")
        loss = counted(paths, f"c2 decoder ODE {H}x{D} semilinear_fused", ("K2", "K3"), rehearse,
                       lambda: _decoder_step(device, wspec, 4 if rehearse else TRAIN_B, 86, H + D))
        print(f"C2 decoder ODE training step (H, D) = ({H}, {D}) on semilinear_fused: loss {loss:.6f} ({smi})",
              flush=True)


def _profile_ops(fn, repeats: int) -> int:
    """Device operations (kernels, copies, sets) per call of ``fn``, from a
    torch.profiler trace of ``repeats`` calls."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(n > 0, "the profiler recorded no device operation")
    return n // repeats


# the kernels each backend's sweep launches: the stacked steps' member-batched
# K2/K3 (K1/K1-bwd fold the members into their batch) and the members' final
# test evaluations' single-model K2
SWEEP = {"semilinear": ("K1", "K1-bwd"), "semilinear_fused": ("K2", "K2-members", "K3-members")}
# the kernels one stacked dual step launches
STACKED = {"semilinear": ("K1", "K1-bwd"), "semilinear_fused": ("K2-members", "K3-members")}


def phase_stacked_step(device, clock: Clock, data_dir: str, rehearse: bool, smi: str):
    """One stacked dual step of S members (svi.make_stacked_dual_step) at the
    CVS training batch on semilinear and semilinear_fused: its kernel launches
    and device operations at S = 1, 2 and 10, its time at S = 1 and 10, and
    ten sequential dual steps (one per member) beside it. Each kernel must
    launch as often at S = 10 as at S = 1."""
    cfg = _config(data_dir, "semilinear")
    train = training_cvs.build_splits(cfg, device=device)[0]["train"]
    ts = torch.arange(86.0, device=device)
    B = 8 if rehearse else TRAIN_B
    for backend in ("semilinear", "semilinear_fused"):
        spec = cvs_spec(_config(data_dir, backend))
        launches, ops, step_ms = {}, {}, {}
        for S in (1, 2, 10):
            params = [init_params(spec, fold_seed(12 + m, "init"), device=device) for m in range(S)]
            optim = svi.make_dual_optimizer(spec, params[0], cfg.learning_rate)
            states = [ensemble.stack_states([svi.SVIState(p, optim.init(p), fold_seed(12 + m, "train"), 0)
                                             for m, p in enumerate(params)])]
            step = svi.make_stacked_dual_step(spec, ts, optim)
            perms = np.stack([np.random.RandomState(12 + m).permutation(len(train["observations"]))[:B]
                              for m in range(S)])
            batch = {k: torch.as_tensor(v[perms], device=device) for k, v in train.items()}
            batch.update(sample_id=torch.as_tensor(perms, device=device), mask=torch.ones(B, device=device))
            dims = {k: 0 for k in batch}
            dims["mask"] = None
            seeds = svi.stacked_step_seeds(states[0].seed, range(40), device=device)
            k = [0]

            def one():
                states[0], _ = step(states[0], batch, dims, seeds[k[0] % 40])
                k[0] += 1

            for _ in range(2):
                one()
            clock.sync()
            zero_counts()
            one()
            clock.sync()
            launches[S] = read_counts()
            t0 = time.perf_counter()
            n = 2 if rehearse else 10
            for _ in range(n):
                one()
            clock.sync()
            step_ms[S] = (time.perf_counter() - t0) * 1e3 / n
            ops[S] = None if rehearse else _profile_ops(one, 3)
            if S == 10:  # ten sequential dual steps: one per member, the same work
                init_state, train_step, _ = svi.make_train_step(spec, ts, cfg.learning_rate, params[0])
                singles = [init_state(p, fold_seed(12 + m, "train")) for m, p in enumerate(params)]
                rows = [{k: v[m] for k, v in batch.items() if dims[k] == 0} | {"mask": batch["mask"]}
                        for m in range(S)]
                for m in range(S):
                    singles[m], _ = train_step(singles[m], rows[m])
                clock.sync()
                t0 = time.perf_counter()
                for m in range(S):
                    singles[m], _ = train_step(singles[m], rows[m])
                clock.sync()
                step_ms["10 sequential"] = (time.perf_counter() - t0) * 1e3
        print(f"stacked dual step {backend} B={B}: launches per step {launches}; device operations per step "
              f"(profiler) S=1 {ops[1]}, S=2 {ops[2]}, S=10 {ops[10]}; time S=1 {step_ms[1]:.3f} ms, "
              f"S=10 {step_ms[10]:.3f} ms, ten sequential dual steps {step_ms['10 sequential']:.3f} ms ({smi})",
              flush=True)
        check(launches[1] == launches[10], f"stacked step {backend}: launches differ at S=1 and S=10: {launches}")
        check(rehearse or all(launches[10][key] > 0 for key in STACKED[backend] + ENCODE_MEMBERS),
              f"stacked step {backend}: {launches[10]}")


def phase_sweeps(device, workdir: str, data_dir: str, rehearse: bool, smi: str, paths: dict):
    """sweep.run at full width: CVS over seeds 12..21 on semilinear and on
    semilinear_fused, proc over seeds 12..16 (its member-group limit) on
    semilinear_fused (its D = 8 member-batched libraries), one epoch beyond
    epoch 0 each. Launches are counted per sweep. Every member's artifacts
    must exist and be finite, sweep.json must parse and deploy_mean/ exist,
    and members 0 and S-1 must match the port's sequential CLI run at their
    seeds: final and best params within rtol 2e-4, atol 1e-6, best epoch
    equal and criterion within rtol 2e-4 (tests/test_ensemble.py's bounds)."""
    n_samples = "4"  # the proc members' sample bands (the config's 200 would be the same work 50 times)
    cases = [("cvs", "semilinear", "12..21"), ("cvs", "semilinear_fused", "12..21"),
             ("proc", "semilinear_fused", "12..16")]
    for dataset, backend, seeds in cases:
        if rehearse:
            seeds = "12,13"
        root = os.path.join(workdir, f"sweep-{dataset}-{backend}")
        common = ["--num-epochs", "1", "--ode-backend", backend, "--device", str(device)]
        extra = ["--data-path", data_dir] if dataset == "cvs" else ["--data-seed", "12", "--num-samples", n_samples]
        t0 = time.perf_counter()
        argv = [dataset, "--seeds", seeds, "--results-root", root] + common + extra
        run, text = counted(paths, f"sweep {dataset} {backend}", SWEEP[backend] + ENCODE_MEMBERS, rehearse,
                            lambda: printed(lambda: sweep.run(sweep.parse_args(argv))), replayed=True)
        wall = time.perf_counter() - t0
        check_dispatch(f"sweep {dataset} {backend}", text, "eager (on cpu" if rehearse else "cuda graph")
        with open(os.path.join(root, "sweep.json")) as f:
            summary = json.load(f)
        check(summary["seeds"] == sweep.parse_seeds(seeds), f"sweep {dataset} {backend}: sweep.json seeds")
        for row in summary["members"]:
            for fname in os.listdir(row["results_dir"]):
                if fname.endswith(".npy"):
                    arr = np.load(os.path.join(row["results_dir"], fname))
                    check(np.isfinite(arr).all(), f"sweep {dataset} {backend} seed {row['seed']}: {fname} not finite")
            check(os.path.exists(os.path.join(row["results_dir"], "mu_50_prior.npy")), "member artifacts")
        check(os.path.exists(os.path.join(root, "deploy_mean", "mu_50_post.npy")),
              f"sweep {dataset} {backend}: no deploy_mean/")
        driver = {"cvs": training_cvs, "proc": training_proc}[dataset]
        members = sweep.parse_seeds(seeds)
        for i in (0, len(members) - 1):
            seed = members[i]
            out = counted(paths, f"sequential {dataset} {backend} seed {seed}", TRAINING[backend] + ENCODE_TRAIN,
                          rehearse,
                          lambda: driver.main(["--seed", str(seed), "--no-plot", "--no-eval-train", "--results-root",
                                               os.path.join(root, f"sequential{seed}")] + common + extra))
            worst = 0.0
            for tree, ref in ((run.result.state.params, out["state"].params),
                              (run.result.best_params, out["best"]["params"])):
                for a, b in zip(tree_leaves(tree), tree_leaves(ref)):
                    worst = max(worst, float(((a[i] - b).abs() / (1e-6 + 2e-4 * b.abs())).max()))
            crit_err = abs(run.result.best_crit[i] - out["best"]["criterion"]) / abs(out["best"]["criterion"])
            print(f"sweep {dataset} {backend} member {i} (seed {seed}) vs its sequential run: params worst "
                  f"error / tolerance {worst:.3f} (rtol 2e-4, atol 1e-6); best epoch {run.result.best_epoch[i]} vs "
                  f"{out['best']['epoch']}; criterion {run.result.best_crit[i]:.6f} vs {out['best']['criterion']:.6f} "
                  f"(rel {crit_err:.2e})", flush=True)
            check(worst <= 1.0, f"sweep {dataset} {backend} member {i} params differ from the sequential run")
            check(int(run.result.best_epoch[i]) == int(out["best"]["epoch"]) and crit_err <= 2e-4,
                  f"sweep {dataset} {backend} member {i}: best epoch or criterion differ from the sequential run")
        print(f"== sweep {dataset} {backend} x {len(members)} members: {wall:.2f} s wall (train "
              f"{summary['train_seconds']:.2f} s), deployments {sorted(summary['deployments'])} ({smi})", flush=True)


def zero_counts():
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "variants"):
            wrapper.variants.clear()


def read_counts():
    return {key: wrapper.launches for key, wrapper in KERNELS.items()}


# the kernels each ODE backend launches: its forward kernel when serving, and
# its backward kernel too when training
FORWARD = {"semilinear": ("K1",), "semilinear_pallas": ("K1",), "semilinear_fused": ("K2",), "semilinear_seq": ()}
TRAINING = {"semilinear": ("K1", "K1-bwd"), "semilinear_fused": ("K2", "K3"), "semilinear_seq": ()}


def counted(paths: dict, name: str, expected, rehearse: bool, fn, replayed: bool = False):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after, into ``paths[name]``: each kernel of ``expected`` must have
    launched, and no other kernel (on the CPU none launches). ``replayed``:
    ``fn`` trains, and its epochs must replay CUDA graphs (train/svi.py)."""
    zero_counts()
    replays = graphs.Graph.replays
    out = fn()
    if replayed:
        n = graphs.Graph.replays - replays
        print(f"epoch dispatch of {name}: {n} CUDA graph replays", flush=True)
        check(rehearse or n > 0, f"{name}: its epochs replayed no CUDA graph")
    paths[name] = counts = read_counts()
    VARIANT_PATHS[name] = {key: collections.Counter(w.variants) for key, w in KERNELS.items() if hasattr(w, "variants")}
    print(f"launches {name}: {counts}", flush=True)
    hold_counts(name, counts, expected, rehearse)
    return out


def hold_counts(name: str, counts: dict, expected, rehearse: bool) -> None:
    """Each kernel of ``expected`` launched on the card, and no other K1-K3
    kernel. The conv encoder's kernels run wherever a path encodes on the
    card, whatever its ODE backend: the ones ``expected`` names must have
    launched, the others are recorded. In a rehearsal none launches."""
    for key, n in counts.items():
        want = key in expected and not rehearse
        if key in CONV_KEYS and not want and not rehearse:
            continue
        check(n > 0 if want else n == 0,
              f"{name}: {key} launched {n} times, expected {'some' if want else 'none'}")


def _config(data_dir: str, backend: str, model: str = "Mechanistic"):
    cfg = load_cvs_config()
    cfg.data_path = data_dir
    cfg.ode_backend = backend
    cfg.model = model
    return cfg


def phase_serving(device, workdir: str, rehearse: bool, paths: dict):
    """Serve requests through serve.main, counting launches per backend
    into ``paths``."""
    data_dir = os.path.join(workdir, "cvs")
    data_size = 40 if rehearse else 1000
    t0 = time.perf_counter()
    make_dataset(data_dir, data_size=data_size, device=device)
    print(f"== serving path: CVS data_size={data_size} generated on {device} in "
          f"{time.perf_counter() - t0:.2f} s ({CARD['smi']})", flush=True)
    n_test = data_size - int(round(data_size * 0.9))
    spec = cvs_spec(_config(data_dir, "semilinear"))
    ckpts = []
    for seed in (0, 1):
        path = os.path.join(workdir, f"member{seed}.npz")
        checkpoint.save(path, params_to_jax(init_params(spec, seed, device=device)))
        ckpts.append(path)

    requests = {
        "posterior": ["--checkpoint", ckpts[0]],
        "prior+classify": ["--checkpoint", ckpts[0], "--prior", "--classify"],
        "ensemble-mean": ["--checkpoint", *ckpts, "--classify"],
    }
    outs = {}

    def serve_all(backend):
        for name, argv in requests.items():
            if backend == "semilinear_pallas" and name != "posterior":
                continue
            out_path = os.path.join(workdir, f"{backend}-{name}.npz")
            outs[backend, name] = serve.main(
                ["--dataset", "cvs", *argv, "--device", str(device), "--output", out_path],
                config=_config(data_dir, backend),
            )

    for backend, expected in FORWARD.items():
        counted(paths, f"serve {backend}", expected + ENCODE, rehearse, lambda: serve_all(backend))
    gauss_cfg = _config(data_dir, "semilinear", "MechanisticGauss")
    gauss_ckpt = os.path.join(workdir, "gauss.npz")
    checkpoint.save(gauss_ckpt, params_to_jax(init_params(cvs_spec(gauss_cfg), 2, device=device)))
    gauss = counted(paths, "serve semilinear Gauss", FORWARD["semilinear"] + ENCODE, rehearse, lambda: serve.main(
        ["--dataset", "cvs", "--checkpoint", gauss_ckpt, "--device", str(device),
         "--output", os.path.join(workdir, "gauss-posterior.npz")],
        config=gauss_cfg,
    ))

    outs["Gauss", "posterior"] = gauss
    _check_served(outs, {"mu_50": (n_test, 3, 86), "solution_xt": (n_test, 86, 5)})
    return ckpts, data_dir


def _check_served(outs: dict, shapes: dict, where: str = "") -> None:
    """Served outputs, keyed (backend, request): the shapes, finite values,
    and every backend against semilinear_seq (a "Gauss" entry has no
    counterpart). max |diff| <= ATOL + RTOL * max |ref| per output: scaled by
    the output's largest value, not elementwise, because the bands are sums
    over state components of |x| up to tens and cancel to small values,
    where the state's roundoff survives in absolute terms."""
    for (backend, name), out in outs.items():
        for k, shape in shapes.items():
            check(out[k].shape == shape, f"{where}{backend} {name} {k} shape {out[k].shape} != {shape}")
        check(all(np.isfinite(v).all() for v in out.values()), f"{where}{backend} {name}: non-finite output")
        if backend == "Gauss":
            continue
        ref = outs["semilinear_seq", name]
        worst = 0.0
        for k in ref:
            diff = float(np.abs(np.asarray(out[k]) - np.asarray(ref[k])).max())
            scale = float(np.abs(np.asarray(ref[k])).max())
            check(diff <= ATOL + RTOL * scale,
                  f"{where}{backend} {name} {k} disagrees with semilinear_seq: {diff} (max |ref| {scale})")
            worst = max(worst, diff)
        print(f"{where}{backend:18s} {name:15s} max |diff| vs semilinear_seq {worst:.3e}", flush=True)


def _check_trained(name: str, out, artifacts: dict):
    """A training run's two logged epoch losses and its test ELBOs are
    finite, and each artifact file has its shape and finite values. Returns
    the epoch losses."""
    rd = out["out_dir"]
    with open(os.path.join(rd, "model.log")) as f:
        losses = [float(line.split("loss=")[1].split()[0]) for line in f if "loss=" in line]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
    check(all(math.isfinite(v) for v in out["test_post"].elbo + out["test_prior"].elbo),
          f"{name}: non-finite test ELBO")
    for fname, shape in artifacts.items():
        arr = np.load(os.path.join(rd, fname))
        check(arr.shape == shape and np.isfinite(arr).all(), f"{name} {fname}: {arr.shape} != {shape}")
    return losses


def phase_request_times(device, clock: Clock, ckpts, data_dir: str, rehearse: bool, smi: str):
    """Host-clock time of one served posterior request, ending in a sync,
    eager (phase 14 times it replayed)."""
    big_b = 64 if rehearse else BIG_B
    for backend in ("semilinear", "semilinear_fused", "semilinear_seq"):
        spec, params, times, splits = serve.load_model("cvs", ckpts[0], _config(data_dir, backend), device)
        recon_fn, _ = serve.make_predict_fns(spec, times, device, dispatch="eager")  # replayed: phase 14
        test = splits["test"]
        for B in (test["observations"].shape[0], big_b):
            idx = np.arange(B) % test["observations"].shape[0]
            batch = {k: torch.as_tensor(v[idx], device=device) for k, v in test.items()}
            batch["sample_id"] = torch.arange(B, device=device)

            def request():
                out = recon_fn(params, 0, batch, True)
                clock.sync()
                return out

            request()
            t0 = time.perf_counter()
            n = 3 if rehearse else 10
            for _ in range(n):
                request()
            ms = (time.perf_counter() - t0) * 1e3 / n
            print(f"request {backend:16s} B={B:6d}: {ms:.3f} ms ({smi})", flush=True)


# the JAX package's artifact contract at CVS (test split of 100): file, shape
ARTIFACTS = {
    "observations.npy": (3, 86), "times.npy": None, "iext.npy": (), "rtpr.npy": (),
    **{f"{k}_{tag}.npy": (3, 86) for k in ("mu_50", "mu_75", "mu_25") for tag in ("post", "prior")},
    **{f"solution_xt_{tag}.npy": (86, 5) for tag in ("post", "prior")},
    **{f"z_{tag}.npy": (15,) for tag in ("post", "prior")},
}


def phase_training(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """training_cvs.main at full width per backend, plus one Gauss run,
    counting launches per run into ``paths``."""
    n_test = (40 if rehearse else 1000) - int(round((40 if rehearse else 1000) * 0.9))
    runs = [(b, "Mechanistic") for b in TRAINING] + [("semilinear", "MechanisticGauss")]
    results = {}
    for backend, model in runs:
        root = os.path.join(workdir, f"train-{backend}-{model}")
        t0 = time.perf_counter()
        name = f"train {backend}" + (" Gauss" if model == "MechanisticGauss" else "")
        results[backend, model] = counted(paths, name, TRAINING[backend] + ENCODE_TRAIN, rehearse,
                                          lambda: training_cvs.main([
            "--num-epochs", "1", "--no-plot", "--ode-backend", backend, "--model", model,
            "--data-path", data_dir, "--results-root", root, "--device", str(device),
        ]), replayed=True)
        print(f"== trained {model} on {backend}: 2 epochs in {time.perf_counter() - t0:.2f} s ({CARD['smi']})",
              flush=True)

    artifacts = {name: (86,) if shape is None else (n_test,) + shape for name, shape in ARTIFACTS.items()}
    for (backend, model), out in results.items():
        losses = _check_trained(f"{backend} {model}", out, artifacts)
        print(f"{backend:18s} {model:17s} epoch losses {losses}, test ELBO post {out['test_post'].elbo}, "
              f"artifacts ok", flush=True)

    # the trained checkpoint, served by the port
    rd = results["semilinear", "Mechanistic"]["out_dir"]
    served = serve.main(
        ["--dataset", "cvs", "--checkpoint", os.path.join(rd, "best_model.npz"), "--device", str(device),
         "--output", os.path.join(workdir, "trained-posterior.npz")],
        config=_config(data_dir, "semilinear"),
    )
    check(served["mu_50"].shape == (n_test, 3, 86) and np.isfinite(served["mu_50"]).all(), "trained model serve")


def _first_step(spec, params, batch, ts, lr: float):
    """The first dual step's main loss and gradients at ``params``, then the
    aux loss and gradients after the main update (svi.make_dual_step's
    order), at fixed seeds."""
    optim = svi.make_dual_optimizer(spec, params, lr)
    main_loss, aux_loss = svi.make_losses(spec, ts)
    loss_m, _, g_m = svi.value_and_grad(main_loss, params, 7, batch)
    params2, _ = optim.update_main(g_m, optim.init(params), params)
    loss_a, _, g_a = svi.value_and_grad(aux_loss, params2, 8, batch)
    return [loss_m, loss_a], tree_leaves(g_m) + tree_leaves(g_a)


def first_step_and_times(clock: Clock, rehearse: bool, smi: str, paths: dict, prefix: str, spec_of, params, batch,
                         ts, lr: float):
    """First-step agreement across the backends (launches counted per
    backend into ``paths``, as ``first step {prefix}{backend}``), then one
    dual step timed per backend. ``spec_of(backend)`` is the model's spec on
    that ODE backend."""
    first = {b: counted(paths, f"first step {prefix}{b}", TRAINING[b], rehearse,
                        lambda: _first_step(spec_of(b), params, batch, ts, lr))
             for b in TRAINING}
    losses_ref, grads_ref = first["semilinear_seq"]
    scale = max(max(float(g.abs().max()) for g in grads_ref), 1.0)
    for backend in ("semilinear", "semilinear_fused"):
        losses, grads = first[backend]
        loss_ratio = max(float((l - r).abs()) / (ATOL + RTOL * float(r.abs())) for l, r in zip(losses, losses_ref))
        grad_err = max(float((g - r).abs().max()) for g, r in zip(grads, grads_ref)) / scale
        leaf_err = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1.0) for g, r in zip(grads, grads_ref))
        print(f"first dual step {prefix}{backend} vs semilinear_seq: losses {[float(l) for l in losses]} "
              f"(error / tolerance {loss_ratio:.3f}); gradients max|diff| / max(max|g_seq|, 1) "
              f"{grad_err:.3e} (tol {STEP_GRAD_TOL:g}; worst leaf by its own scale {leaf_err:.3e})", flush=True)
        check(loss_ratio <= 1.0, f"first-step losses of {prefix}{backend} disagree with semilinear_seq")
        check(grad_err < STEP_GRAD_TOL, f"first-step gradients of {prefix}{backend} disagree with semilinear_seq")

    step_ms = {}
    B = batch["observations"].shape[0]
    for backend in TRAINING:
        init_state, train_step, _ = svi.make_train_step(spec_of(backend), ts, lr, params)
        state = init_state(params, 0)
        for _ in range(2):  # warm-up
            state, _m = train_step(state, batch)
        clock.sync()
        n = 2 if rehearse else 10
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = train_step(state, batch)
        clock.sync()
        step_ms[backend] = (time.perf_counter() - t0) * 1e3 / n
        print(f"dual step {prefix}{backend:16s} B={B}: {step_ms[backend]:.3f} ms ({smi})", flush=True)
    return step_ms


def phase_train_checks(device, clock: Clock, data_dir: str, rehearse: bool, smi: str, paths: dict):
    """First-step agreement across the backends (launches counted per
    backend into ``paths``), then one dual step timed."""
    cfg = _config(data_dir, "semilinear")
    splits, _ = training_cvs.build_splits(cfg, device=device)
    batches = device_batch(stacked_minibatches(splits["train"], TRAIN_B, shuffle=False), device)
    batch = {k: v[0] for k, v in batches.items()}
    ts = torch.arange(86.0, device=device)
    params = init_params(cvs_spec(cfg), 0, device=device)
    return first_step_and_times(clock, rehearse, smi, paths, "", lambda b: cvs_spec(_config(data_dir, b)), params,
                                batch, ts, cfg.learning_rate)


def _workload_config(wl: str, backend: str, model: str = "Mechanistic"):
    cfg = LOADERS[wl]()
    cfg.ode_backend = backend
    cfg.model = model
    return cfg


def phase_workloads(device, clock: Clock, workdir: str, rehearse: bool, smi: str, paths: dict):
    """proc and challenge on their datasets: served, trained, first step
    compared and one dual step timed per backend, each path's launches
    counted into ``paths``. Returns the dual-step times per workload."""
    step_ms = {}
    for wl, w in WORKLOADS.items():
        n, T, D = w["val_b"], w["T"], w["D"]
        spec = w["spec"](_workload_config(wl, "semilinear"), n_time=T)
        print(f"== {wl}: serving the val fold (B = {n}, T = {T}, ODE state {D}, latent {spec.latent_dim})",
              flush=True)
        ckpts = []
        for seed in (0, 1):
            path = os.path.join(workdir, f"{wl}-member{seed}.npz")
            checkpoint.save(path, params_to_jax(init_params(spec, seed, device=device)))
            ckpts.append(path)
        requests = {
            "posterior": ["--checkpoint", ckpts[0]],
            "prior+classify": ["--checkpoint", ckpts[0], "--prior", "--classify"],
            "ensemble-mean": ["--checkpoint", *ckpts, "--classify"],
        }
        outs = {}

        def serve_all(backend):
            for name, argv in requests.items():
                outs[backend, name] = serve.main(
                    ["--dataset", wl, *argv, "--split", "val", "--device", str(device),
                     "--output", os.path.join(workdir, f"{wl}-{backend}-{name}.npz")],
                    config=_workload_config(wl, backend),
                )

        for backend in TRAINING:
            counted(paths, f"serve {wl} {backend}", FORWARD[backend] + ENCODE, rehearse, lambda: serve_all(backend))
        gauss_cfg = _workload_config(wl, "semilinear", "MechanisticGauss")
        gauss_ckpt = os.path.join(workdir, f"{wl}-gauss.npz")
        checkpoint.save(gauss_ckpt, params_to_jax(init_params(w["spec"](gauss_cfg, n_time=T), 2, device=device)))
        outs["Gauss", "posterior"] = counted(paths, f"serve {wl} semilinear Gauss", FORWARD["semilinear"] + ENCODE,
                                             rehearse,
                                             lambda: serve.main(
            ["--dataset", wl, "--checkpoint", gauss_ckpt, "--split", "val", "--device", str(device),
             "--output", os.path.join(workdir, f"{wl}-gauss-posterior.npz")], config=gauss_cfg))
        _check_served(outs, {"mu_50": (n, 4, T), "solution_xt": (n, T, D)}, f"{wl} ")

        # training at full width on the full dataset, 2 epochs, the config's
        # sample bands (2 draws in a rehearsal)
        n_samples = 2 if rehearse else LOADERS[wl]().num_samples
        artifacts = {"observations.npy": (n, 4, T), "times.npy": (T,),
                     **({"treatments.npy": (n, 2), "devices.npy": (n, 7)} if wl == "proc"
                        else {"shedding.npy": (n,), "symptoms.npy": (n,)})}
        for tag in ("post", "prior"):
            artifacts.update({f"{q}_{tag}.npy": (n, 4, T) for q in ("mu_25", "mu_50", "mu_75")})
            artifacts.update({f"{q}_{tag}_sample.npy": (n, 4, T, n_samples) for q in ("mu_25", "mu_50", "mu_75")})
            artifacts[f"solution_xt_{tag}.npy"] = (n, T, D)
            artifacts[f"z_{tag}.npy"] = (n, spec.latent_dim)
        results = {}
        for backend, model in [(b, "Mechanistic") for b in TRAINING] + [("semilinear", "MechanisticGauss")]:
            name = f"train {wl} {backend}" + (" Gauss" if model == "MechanisticGauss" else "")
            argv = ["--num-epochs", "1", "--no-plot", "--ode-backend", backend, "--model", model,
                    "--num-samples", str(n_samples), "--device", str(device),
                    "--results-root", os.path.join(workdir, f"train-{wl}-{backend}-{model}")]
            t0 = time.perf_counter()
            out = results[backend, model] = counted(paths, name, TRAINING[backend] + ENCODE_TRAIN, rehearse,
                                                    lambda: w["driver"].main(argv), replayed=True)
            losses = _check_trained(name, out, artifacts)
            print(f"== {name}: 2 epochs, test and {n_samples}-draw bands in {time.perf_counter() - t0:.2f} s; "
                  f"epoch losses {losses}, best epoch {out['best']['epoch']}, artifacts ok ({CARD['smi']})",
                  flush=True)
        rd = results["semilinear", "Mechanistic"]["out_dir"]
        served = serve.main(
            ["--dataset", wl, "--checkpoint", os.path.join(rd, "best_model.npz"), "--split", "val",
             "--device", str(device), "--output", os.path.join(workdir, f"{wl}-trained-posterior.npz")],
            config=_workload_config(wl, "semilinear"),
        )
        check(served["mu_50"].shape == (n, 4, T) and np.isfinite(served["mu_50"]).all(), f"{wl}: trained model serve")

        # the first dual step across the backends, and one step timed, at the
        # workload's training batch
        cfg = _workload_config(wl, "semilinear")
        _, splits, times = serve._build(wl, cfg, device)
        batches = device_batch(stacked_minibatches(splits["train"], w["train_b"], shuffle=False), device)
        batch = {k: v[0] for k, v in batches.items()}
        params = init_params(spec, 0, device=device)
        step_ms[wl] = first_step_and_times(
            clock, rehearse, smi, paths, f"{wl} ", lambda b: w["spec"](_workload_config(wl, b), n_time=T), params,
            batch, torch.as_tensor(times, device=device), cfg.learning_rate)
    return step_ms


def _trips():
    """The adaptive solvers' trip counters, summed: solves, trips, accepted."""
    return solvers.odeint_adaptive.trips + solvers.odeint_adaptive_per_sample.trips


def _two_dual_steps(spec, params, batch, ts, lr: float):
    """Two dual steps from ``params``: the first written out as
    svi.make_dual_step runs it, so that its losses and gradients (main, then
    aux after the main update) come back for the checks, the second by
    make_dual_step itself. Returns ((losses, gradients), state, metrics)."""
    optim = svi.make_dual_optimizer(spec, params, lr)
    main_loss, aux_loss = svi.make_losses(spec, ts)
    seed = fold_seed(0, 0)
    loss_m, _, g_m = svi.value_and_grad(main_loss, params, fold_seed(seed, "main"), batch)
    params1, opt = optim.update_main(g_m, optim.init(params), params)
    loss_a, _, g_a = svi.value_and_grad(aux_loss, params1, fold_seed(seed, "aux"), batch)
    params1, opt = optim.update_aux(g_a, opt, params1)
    state, mets = svi.make_dual_step(spec, ts, optim)(svi.SVIState(params1, opt, 0, 1), batch)
    return ([loss_m, loss_a], tree_leaves(g_m) + tree_leaves(g_a)), state, mets


def _per_solve(before, after) -> str:
    d = {k: after[k] - before[k] for k in ("solves", "trips", "accepted")}
    if not d["solves"]:
        return "no adaptive solve"
    return (f"{d['solves']} adaptive solves, {d['trips'] / d['solves']:.1f} trips a solve "
            f"({d['accepted'] / d['solves']:.1f} accepted)")


def phase_menu(device, clock: Clock, data_dir: str, rehearse: bool, smi: str, paths: dict):
    """Phase 8, the ODE backend menu at CVS full width (T = 86, latent 15,
    ODE state 5, hidden 25; a request is the test split, B = 100, a training
    batch B = 128; random weights from seed 0): for generic, adjoint,
    adaptive, adaptive_per_sample and semilinear_auto, one served request
    and two dual steps, each timed, with launches counted per path and the
    adaptive solvers' trips per solve; then the checks: generic (midpoint)
    served within ATOL + RTOL * max of semilinear's; adjoint's forward equal
    to generic's to float32 roundoff and its first-step gradients within
    rtol 2e-2, atol 1e-2 of generic's autograd gradients at rk4 (each leaf
    to its largest value; at midpoint printed, not held); the adaptive
    backends' served solution and bands within rtol 5e-3, atol 5e-3 of
    generic at rk4, their first-step gradients finite and not all zero;
    semilinear_auto's choice printed at the three workloads' widths and at
    the CVS sweep's S = 10, and its launches those of the path it chose."""
    cfg = _config(data_dir, "semilinear")
    splits = training_cvs.build_splits(cfg, device=device)[0]
    ts = torch.arange(86.0, device=device)
    times = np.arange(86.0, dtype=np.float32)
    params = init_params(cvs_spec(cfg), 0, device=device)
    test = {k: torch.as_tensor(v, device=device) for k, v in splits["test"].items()}
    test["sample_id"] = torch.arange(test["observations"].shape[0], device=device)
    train = {k: v[0] for k, v in device_batch(stacked_minibatches(splits["train"], TRAIN_B, shuffle=False),
                                               device).items()}

    def spec_of(backend, solver="midpoint"):
        c = _config(data_dir, backend)
        c.solver = solver
        return cvs_spec(c)

    def expected(backend, training: bool):
        if backend == "semilinear":  # the reference: served only
            return ("K1",)
        if backend != "semilinear_auto":
            return ()
        fused = auto_picks_fused(spec_of(backend).decoder.ode, torch.empty((TRAIN_B, 15), device=device))
        if fused:
            return ("K2", "K3") if training else ("K2",)
        return ("K1", "K1-bwd") if training else ("K1",)

    served, first, times_ms = {}, {}, {}
    runs = [(b, "midpoint") for b in MENU] + [("semilinear", "midpoint"), ("generic", "rk4")]
    for backend, solver in runs:
        name = backend if solver == "midpoint" else f"{backend} {solver}"
        spec = spec_of(backend, solver)
        recon_fn, _ = serve.make_predict_fns(spec, times, device)
        t0, before = time.perf_counter(), _trips()
        out = counted(paths, f"menu serve {name}", expected(backend, False), rehearse,
                      lambda: recon_fn(params, 0, test, True))
        clock.sync()
        req_ms = (time.perf_counter() - t0) * 1e3
        req_trips = _per_solve(before, _trips())
        served[name] = {k: v for k, v in out.items() if k != "l1"}
        check(all(torch.isfinite(v).all() for v in served[name].values()), f"menu {name}: non-finite served output")
        if name not in MENU:  # the references serve only
            continue
        t0, before = time.perf_counter(), _trips()
        first[name], state, mets = counted(paths, f"menu train {name}", expected(backend, True), rehearse,
                                           lambda: _two_dual_steps(spec, params, train, ts, cfg.learning_rate))
        clock.sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        step_trips = _per_solve(before, _trips())
        check(math.isfinite(float(mets["loss_main"])) and all(torch.isfinite(p).all()
                                                              for p in tree_leaves(state.params)),
              f"menu {name}: non-finite training step")
        times_ms[name] = (req_ms, step_ms)
        print(f"menu {name:20s}: request B={test['observations'].shape[0]} {req_ms:.1f} ms ({req_trips}); dual "
              f"step B={TRAIN_B} {step_ms:.1f} ms a step ({step_trips}) ({smi})", flush=True)

    def scaled(a, b, atol, rtol):
        """max|a - b| against atol + rtol * max|b| (the served bands are
        sums over the state's components: held to their largest value)."""
        return float((a - b).abs().max()) / (atol + rtol * float(b.abs().max()))

    # generic (midpoint) against semilinear; adjoint's forward against generic's
    for name, ref in (("generic", "semilinear"), ("adjoint", "generic")):
        worst = max(scaled(served[name][k], served[ref][k], ATOL, RTOL) for k in served[ref])
        print(f"menu {name} served vs {ref}: worst error / tolerance {worst:.3f} ({ATOL:g} + {RTOL:g} * max)",
              flush=True)
        check(worst <= 1.0, f"menu: {name}'s served outputs disagree with {ref}'s")
    # the adaptive backends against generic at rk4, elementwise (JAX's bound)
    for name in ("adaptive", "adaptive_per_sample"):
        worst = max(ratio(served[name][k], served["generic rk4"][k], ADAPTIVE_ATOL, ADAPTIVE_RTOL)
                    for k in ("solution_xt", "mu_25", "mu_50", "mu_75"))
        print(f"menu {name} served vs generic rk4: worst error / tolerance {worst:.3f} "
              f"(rtol {ADAPTIVE_RTOL:g}, atol {ADAPTIVE_ATOL:g})", flush=True)
        check(worst <= 1.0, f"menu: {name}'s served outputs disagree with generic at rk4")
        grads = first[name][1]
        check(all(torch.isfinite(g).all() for g in grads) and any(float(g.abs().sum()) > 0 for g in grads),
              f"menu {name}: first-step gradients not finite or all zero")
    # The continuous adjoint's first-step gradients against generic's
    # autograd ones, each leaf to its own scale (max|a - g| <= atol + rtol *
    # max|g|). The two differ by the solver's discretisation error, which
    # at CVS's unit steps is large at midpoint (O(h^2): printed, not held)
    # and small at rk4 (O(h^4): held); an elementwise rtol would hold the
    # elements of a leaf that pass near zero to atol alone.
    for solver in ("rk4",):
        first[f"adjoint {solver}"] = _first_step(spec_of("adjoint", solver), params, train, ts, cfg.learning_rate)
        first[f"generic {solver}"] = _first_step(spec_of("generic", solver), params, train, ts, cfg.learning_rate)
    for solver, held in (("midpoint", False), ("rk4", True)):
        sfx = "" if solver == "midpoint" else f" {solver}"
        (la, ga), (lg, gg) = first["adjoint" + sfx], first["generic" + sfx]
        worst = max(float((a - g).abs().max()) / (ADJOINT_ATOL + ADJOINT_RTOL * float(g.abs().max()))
                    for a, g in zip(ga, gg))
        print(f"menu adjoint first-step gradients vs generic's autograd at {solver}: worst error / tolerance "
              f"{worst:.3f} (rtol {ADJOINT_RTOL:g}, atol {ADJOINT_ATOL:g} of each leaf's largest"
              f"{'' if held else '; printed, not held'}); losses {[float(x) for x in la]} vs "
              f"{[float(x) for x in lg]}", flush=True)
        check(not held or worst <= 1.0, f"menu: the adjoint's first-step gradients disagree with generic's at {solver}")

    # semilinear_auto's choice at each workload's widths and batches, and
    # at the CVS sweep's ten members (under the stacked step's vmap z holds
    # one member's batch)
    for wl, B, D in (("cvs", SERVE_B, 5), ("cvs", TRAIN_B, 5), ("proc", 78, 8), ("proc", 36, 8),
                     ("challenge", 7, 5), ("challenge", 32, 5), ("cvs sweep S=10", TRAIN_B, 5)):
        for solver in ("midpoint", "rk4", "dopri5"):
            ode = OdeModelSpec(latent_dim=15, ode_state_dim=D, ode_hidden_dim=25, solver=solver,
                               backend="semilinear_auto")
            z = torch.empty((B, 15), device=device)
            pick = "fused K2/K3" if auto_picks_fused(ode, z) else "K1/K1-bwd"
            print(f"semilinear_auto on {device.type}: {wl} B={B} D={D} {solver}: {pick}", flush=True)
    return times_ms


def phase_menu_sweeps(device, workdir: str, rehearse: bool, smi: str, paths: dict):
    """Two-member CVS sweeps (seeds 12, 13), one epoch, on adjoint and on
    adaptive, each member held to the sequential CLI run of its seed at
    the ensemble bounds (phase_sweeps' checks). Cut to keep the phase to
    minutes (MENU_SWEEP_DATA): one epoch (epoch 0) in place of two, 40
    generated trajectories (32 train: one dual step, at the training batch)
    in place of 1,000, and no per-epoch train-split statistics."""
    data_dir = os.path.join(workdir, "cvs-menu")
    make_dataset(data_dir, data_size=MENU_SWEEP_DATA, device=device)
    for backend in ("adjoint", "adaptive"):
        t0, before = time.perf_counter(), _trips()
        root = os.path.join(workdir, f"sweep-menu-{backend}")
        common = ["--num-epochs", "0", "--ode-backend", backend, "--device", str(device), "--data-path", data_dir]
        run, text = counted(paths, f"sweep cvs {backend}", (), rehearse, lambda: printed(lambda: sweep.run(
            sweep.parse_args(["cvs", "--seeds", "12,13", "--results-root", root] + common))))
        wall = time.perf_counter() - t0
        check_dispatch(f"sweep cvs {backend}", text, "eager (on cpu" if rehearse else
                       svi.epoch_dispatch(run.members[0]["spec"], device))
        for i, seed in enumerate((12, 13)):
            out = counted(paths, f"sequential cvs {backend} seed {seed}", (), rehearse, lambda: training_cvs.main(
                ["--seed", str(seed), "--no-plot", "--no-eval-train", "--results-root",
                 os.path.join(root, f"sequential{seed}")] + common))
            worst = 0.0
            for tree, ref in ((run.result.state.params, out["state"].params),
                              (run.result.best_params, out["best"]["params"])):
                for a, b in zip(tree_leaves(tree), tree_leaves(ref)):
                    worst = max(worst, float(((a[i] - b).abs() / (1e-6 + 2e-4 * b.abs())).max()))
            crit_err = abs(run.result.best_crit[i] - out["best"]["criterion"]) / abs(out["best"]["criterion"])
            print(f"sweep cvs {backend} member {i} (seed {seed}) vs its sequential run: params worst error / "
                  f"tolerance {worst:.3f} (rtol 2e-4, atol 1e-6); best epoch {run.result.best_epoch[i]} vs "
                  f"{out['best']['epoch']}; criterion rel {crit_err:.2e}", flush=True)
            check(worst <= 1.0, f"sweep cvs {backend} member {i}: params differ from the sequential run")
            check(int(run.result.best_epoch[i]) == int(out["best"]["epoch"]) and crit_err <= 2e-4,
                  f"sweep cvs {backend} member {i}: best epoch or criterion differ from the sequential run")
        print(f"== sweep cvs {backend} x 2 members: {wall:.2f} s wall; {_per_solve(before, _trips())} in the sweep "
              f"and its sequential runs ({smi})", flush=True)


# phase 9: resume runs (workload, backend), each held bit for bit to its
# uninterrupted run; the samplers' draws on the card
RESUME_RUNS = (("cvs", "semilinear_fused"), ("cvs", "semilinear"), ("proc", "semilinear_fused"))
SAMPLER_DRAWS = 1 << 20
DRIVERS = {"cvs": training_cvs, "proc": training_proc}


def _leaves(rd: str) -> dict:
    """A results directory's arrays by name: every leaf of train_state.npz
    and best_model.npz, and every .npy artifact."""
    out = {}
    for npz in ("train_state.npz", "best_model.npz"):
        path = os.path.join(rd, npz)
        if os.path.exists(path):
            with np.load(path) as z, open(path + ".json") as f:
                out.update({f"{npz}:{p}": z[f"leaf_{i}"] for i, p in enumerate(json.load(f)["paths"])})
    for name in sorted(os.listdir(rd)):
        if name.endswith(".npy"):
            out[name] = np.load(os.path.join(rd, name))
    return out


def _bit_equal(a: str, b: str, what: str) -> int:
    """Every array of results directory ``b`` bit for bit ``a``'s (NaNs in
    equal places); returns the number compared."""
    la, lb = _leaves(a), _leaves(b)
    check(sorted(la) == sorted(lb), f"{what}: the arrays differ in name: {sorted(set(la) ^ set(lb))}")
    differ = []
    for name, x in la.items():
        y = lb[name]
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            err = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()) if x.shape == y.shape else None
            differ.append(f"{name} (max |diff| {err})")
    check(not differ, f"{what}: not bit for bit equal: {differ}")
    return len(la)


def phase_resume(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """Each RESUME_RUNS case at full width: epochs 0-2 uninterrupted with
    --checkpoint-every 1, and epochs 0-1 then --resume to epoch 2; every
    array of the two results directories bit for bit equal. Each run's
    launches counted: its backend's forward and backward kernels, no other."""
    for wl, backend in RESUME_RUNS:
        common = ["--no-plot", "--ode-backend", backend, "--checkpoint-every", "1", "--device", str(device)]
        if wl == "cvs":
            common += ["--data-path", data_dir]
        else:
            common += ["--num-samples", "2" if rehearse else str(LOADERS[wl]().num_samples)]
        full, part = (os.path.join(workdir, f"resume-{wl}-{backend}-{k}") for k in ("full", "part"))
        driver = DRIVERS[wl]
        t0 = time.perf_counter()
        out = counted(paths, f"resume {wl} {backend}: epochs 0-2", TRAINING[backend], rehearse,
                      lambda: driver.main(common + ["--num-epochs", "2", "--results-root", full]), replayed=True)
        t1 = time.perf_counter()
        counted(paths, f"resume {wl} {backend}: epochs 0-1", TRAINING[backend], rehearse,
                lambda: driver.main(common + ["--num-epochs", "1", "--results-root", part]), replayed=True)
        t2 = time.perf_counter()
        resumed = counted(paths, f"resume {wl} {backend}: --resume to epoch 2", TRAINING[backend], rehearse,
                          lambda: driver.main(common + ["--num-epochs", "2", "--resume", "--results-root", part]),
                          replayed=True)
        t3 = time.perf_counter()
        n = _bit_equal(out["out_dir"], resumed["out_dir"], f"resume {wl} {backend}")
        check(out["best"]["epoch"] == resumed["best"]["epoch"], f"resume {wl} {backend}: best epochs differ")
        print(f"== resume {wl} {backend}: {n} arrays (train_state.npz and best_model.npz leaves, .npy artifacts) "
              f"bit for bit equal; best epoch {out['best']['epoch']}; runs of 3, 2 and 1 epochs in "
              f"{t1 - t0:.2f}, {t2 - t1:.2f}, {t3 - t2:.2f} s ({CARD['smi']})", flush=True)


# phase 12: the backends whose epochs it holds against eager, with their kernels
GRAPH_BACKENDS = {"semilinear_fused": ("K2", "K3"), "semilinear": ("K1", "K1-bwd")}
GRAPH_REPEATS = 5
# the host's calls that put work on the card, counted per step in a trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def _graphs_of(memo) -> list:
    """The utils/graphs.py Graphs held by one of train/svi.py's memos."""
    return [g.run for g in memo._d.values()]


def _states_equal(a, b) -> bool:
    return (a.step == b.step and a.seed == b.seed
            and [s.count for s in svi._slots(a.opt)] == [s.count for s in svi._slots(b.opt)]
            and all(torch.equal(x, y) for x, y in zip(svi._tensors(a), svi._tensors(b))))


def _trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _median_ms(fn, n: int, device) -> float:
    """Median host time of ``n`` calls of ``fn``, each ending in a synchronise."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _trace_epochs(fn, n: int, steps: int, tries: int = 2) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` (an epoch of ``steps``
    dual steps): per step the wall time, the device's busy time (the union
    of its operations' intervals), the idle share, the operations' durations
    summed (above the busy time where records overlap), the host's
    launching calls (LAUNCH_CALLS) and the NCCL kernels' own device time
    (kernels named nccl...). A trace that recorded no device operation (a
    traced request of a few ms came back so once on the card) is taken
    again, ``tries`` times in all."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (n * steps)
    events = prof.events()
    if tries > 1 and not any(e.device_type == DeviceType.CUDA for e in events):
        print("the profiler recorded no device operation: tracing again", flush=True)
        return _trace_epochs(fn, n, steps, tries - 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    busy = busy / 1e3 / (n * steps)
    summed = sum(b - a for a, b in spans) / 1e3 / (n * steps)
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS) / (n * steps)
    nccl = sum(e.time_range.end - e.time_range.start for e in events
               if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()) / 1e3 / (n * steps)
    check(busy > 0, "the profiler recorded no device operation")
    return {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_ops_summed_ms": summed, "host_launches": launches, "nccl_kernels_ms": nccl}


def phase_graphs(device, data_dir: str, rehearse: bool, smi: str, paths: dict) -> dict:
    """The dual step and the eval epochs replayed as CUDA graphs, held
    against eager at CVS, proc and challenge on GRAPH_BACKENDS: two epochs
    from one state (the first warms up, captures and replays, the second
    only replays), each bit for bit the eager epoch (params, moments,
    counts, per-step metrics) with the same launches; each eval epoch (val
    and train, posterior and prior) twice, bit for bit eager, launches
    equal. Then, median of GRAPH_REPEATS, host clock to a synchronize: a
    dual step (an epoch over its steps), an eval epoch and, at CVS, a whole
    epoch as the driver runs it (training and the four eval epochs), eager
    and replayed, and a fresh capture of the step and of the val eval
    epoch; each graph's pool; and a traced epoch each way (device idle
    share, host launches a step). In a rehearsal the graphs' plain version
    runs."""
    graphed = "plain" if rehearse else None
    out = {}
    for wl in RANK_WORKLOADS:
        cfg = _config(data_dir, "semilinear") if wl == "cvs" else _workload_config(wl, "semilinear")
        _, splits, times = serve._build(wl, cfg, device)
        ts = torch.as_tensor(np.asarray(times, dtype=np.float32), device=device)
        B = 8 if rehearse and wl == "cvs" else RANK_WORKLOADS[wl]["train_b"]
        batches = device_batch(stacked_minibatches(splits["train"], B, shuffle=True, rng=np.random.RandomState(0)),
                               device)
        stacks = {name: device_batch(stacked_minibatches(splits[name], B, shuffle=False), device)
                  for name in ("val", "train")}
        steps = batches["mask"].shape[0]
        for backend, kernels in GRAPH_BACKENDS.items():
            case, t0 = f"graphs {wl} {backend}", time.perf_counter()
            spec = _rank_spec(wl, data_dir, backend)
            dispatch = svi.epoch_dispatch(spec, device)
            check(rehearse or dispatch == "cuda graph", f"{case}: epoch dispatch {dispatch}")
            params = init_params(spec, 0, device=device)
            init_state, _, eager_epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch="eager")
            _, _, graph_epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch=graphed)
            eager_eval = svi.make_eval_epoch(spec, ts, dispatch="eager")
            graph_eval = svi.make_eval_epoch(spec, ts, dispatch=graphed)
            svi._TRAIN_GRAPHS.clear()  # fresh captures: their times
            svi._EVAL_GRAPHS.clear()
            s_eager, s_graph = init_state(params, 5), init_state(params, 5)
            for epoch in range(2):
                s_eager, m_eager = counted(paths, f"{case} epoch {epoch} eager", kernels, rehearse,
                                           lambda: eager_epoch(s_eager, batches))
                replays = graphs.Graph.replays
                s_graph, m_graph = counted(paths, f"{case} epoch {epoch} graph", kernels, rehearse,
                                           lambda: graph_epoch(s_graph, batches))
                check(rehearse or graphs.Graph.replays - replays == steps - (1 - epoch) * 1,
                      f"{case} epoch {epoch}: {graphs.Graph.replays - replays} replays of {steps} steps")
                check(_states_equal(s_eager, s_graph), f"{case} epoch {epoch}: the replayed state differs from eager")
                check(_trees_equal(m_eager, m_graph), f"{case} epoch {epoch}: the replayed metrics differ from eager")
                check(paths[f"{case} epoch {epoch} eager"] == paths[f"{case} epoch {epoch} graph"],
                      f"{case} epoch {epoch}: launches differ from eager")
            check(len(_graphs_of(svi._TRAIN_GRAPHS)) == 1, f"{case}: one step graph")
            params_now = svi.own_state(s_eager).params
            for name in ("val", "train"):
                for is_post in (True, False):
                    seed = fold_seed(7, name, is_post)
                    tag = f"{case} eval {name} {'post' if is_post else 'prior'}"
                    ref = counted(paths, f"{tag} eager", kernels[:1], rehearse,
                                  lambda: eager_eval(params_now, seed, stacks[name], is_post))
                    for call in range(2):
                        got = counted(paths, f"{tag} graph {call}", kernels[:1], rehearse,
                                      lambda: graph_eval(params_now, seed, stacks[name], is_post))
                        check(_trees_equal(ref, got), f"{tag} call {call}: the replayed statistics differ from eager")
                        check(paths[f"{tag} eager"] == paths[f"{tag} graph {call}"], f"{tag}: launches differ")
            print(f"== {case}: two epochs of {steps} steps and four eval epochs, replayed bit for bit eager, "
                  f"launches equal", flush=True)

            n = 2 if rehearse else GRAPH_REPEATS
            rec = {"steps": steps, "B": B}
            s_e, s_g = svi.own_state(s_eager), s_graph
            rec["epoch_eager_ms"] = _median_ms(lambda: eager_epoch(s_e, batches), n, device)
            rec["epoch_replayed_ms"] = _median_ms(lambda: graph_epoch(s_g, batches), n, device)
            rec["step_eager_ms"] = rec["epoch_eager_ms"] / steps
            rec["step_replayed_ms"] = rec["epoch_replayed_ms"] / steps
            rec["eval_eager_ms"] = _median_ms(lambda: eager_eval(params_now, 3, stacks["val"], True), n, device)
            rec["eval_replayed_ms"] = _median_ms(lambda: graph_eval(params_now, 3, stacks["val"], True), n, device)
            if wl == "cvs":
                def whole(epoch_fn, eval_fn):
                    def run():
                        epoch_fn(s_e, batches)
                        for name in ("val", "train"):
                            for is_post in (True, False):
                                eval_fn(params_now, 3, stacks[name], is_post)
                    return run
                rec["cvs_epoch_eager_ms"] = _median_ms(whole(eager_epoch, eager_eval), n, device)
                rec["cvs_epoch_replayed_ms"] = _median_ms(whole(graph_epoch, graph_eval), n, device)
            # capture times: fresh graphs of the step (two steps: a warm-up, then the capture) and of the val eval
            two = {k: torch.cat([v[:1], v[:1]]) for k, v in batches.items()}
            captures = {"train": [], "eval": []}
            for _ in range(n):
                svi._TRAIN_GRAPHS.clear()
                svi._EVAL_GRAPHS.clear()
                t0_ns = time.perf_counter_ns()
                graph_epoch(svi.own_state(s_eager), two)
                captures["train"] += _captures_since(t0_ns)
                t0_ns = time.perf_counter_ns()
                graph_eval(params_now, 3, stacks["val"], True)
                graph_eval(params_now, 3, stacks["val"], True)
                captures["eval"] += _captures_since(t0_ns)
            rec["capture_ms"] = {k: float(np.median(v)) for k, v in captures.items()}
            s_g = graph_epoch(s_g, batches)[0]  # over the last capture's buffers: the traced epoch copies no state in
            if not rehearse:
                rec["trace_eager"] = _trace_epochs(lambda: eager_epoch(s_e, batches), 1, steps)
                rec["trace_replayed"] = _trace_epochs(lambda: graph_epoch(s_g, batches), 1, steps)
            rec["case_s"] = time.perf_counter() - t0
            out[f"{wl} {backend}"] = rec
            print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)
    return out


# phase 12's other capturable backends, at CVS: the plain loop and the
# fixed-step solvers under autograd and the continuous adjoint
GRAPH_MENU = ("semilinear_seq", "generic", "adjoint")


def phase_graph_menu(device, data_dir: str, rehearse: bool, paths: dict) -> dict:
    """One training epoch of CVS (B = 128) as a CUDA graph on each
    GRAPH_MENU backend (a warm-up step, the capture, replays), bit for bit
    the eager epoch, launching no kernel of the port; then one more epoch
    replayed throughout, timed beside the eager one (one each, host clock to
    a synchronize)."""
    graphed = "plain" if rehearse else None
    cfg = _config(data_dir, "semilinear")
    _, splits, times = serve._build("cvs", cfg, device)
    ts = torch.as_tensor(np.asarray(times, dtype=np.float32), device=device)
    B = 8 if rehearse else TRAIN_B
    batches = device_batch(stacked_minibatches(splits["train"], B, shuffle=True, rng=np.random.RandomState(0)), device)
    out = {}
    for backend in GRAPH_MENU:
        case = f"graphs cvs {backend}"
        spec = _rank_spec("cvs", data_dir, backend)
        dispatch = svi.epoch_dispatch(spec, device)
        check(rehearse or dispatch == "cuda graph", f"{case}: epoch dispatch {dispatch}")
        params = init_params(spec, 0, device=device)
        init_state, _, eager_epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch="eager")
        _, _, graph_epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch=graphed)
        s0 = init_state(params, 5)
        t0 = time.perf_counter()
        s_eager, m_eager = counted(paths, f"{case} eager", (), rehearse, lambda: eager_epoch(s0, batches))
        _sync(device)
        eager_ms = (time.perf_counter() - t0) * 1e3
        s_graph, m_graph = counted(paths, f"{case} graph", (), rehearse, lambda: graph_epoch(s0, batches))
        check(_states_equal(s_eager, s_graph) and _trees_equal(m_eager, m_graph),
              f"{case}: the replayed epoch differs from eager")
        t0 = time.perf_counter()
        graph_epoch(s_graph, batches)
        _sync(device)
        out[backend] = {"epoch_eager_ms": eager_ms, "epoch_replayed_ms": (time.perf_counter() - t0) * 1e3,
                        "steps": batches["mask"].shape[0]}
        print(f"== {case}: an epoch replayed bit for bit eager; {json.dumps(out[backend])}", flush=True)
    return out


# the fused kernels' names in a profiler trace (csrc/fused_semilinear_*.cu)
TRACE_NAMES = {"K2": "fused_semilinear_fwd_kernel", "K3": "fused_semilinear_bwd_kernel"}


# phase 13: the sweeps whose epochs it holds replayed against eager: (dataset,
# backend, seeds, refit epochs); member groups of SWEEP_GROUP where the seeds
# split into them
SWEEP_GRAPH_CASES = (("cvs", "semilinear_fused", "12..21", 0), ("cvs", "semilinear", "12..21", 0),
                     ("proc", "semilinear_fused", "12..16", 1), ("challenge", "semilinear_fused", "12,13", 0))
SWEEP_GROUP = 5
SWEEP_MEMOS = {"step": ensemble._STEP_GRAPHS, "val": ensemble._VAL_GRAPHS, "refit": ensemble._REFIT_GRAPHS}


class _Tee:
    """A stdout that also keeps what it is given."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, text: str) -> int:
        self.seen.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def printed(fn):
    """``fn()`` and what it printed (which still reaches stdout)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn()
    return out, "".join(tee.seen)


def check_dispatch(name: str, text: str, want: str) -> None:
    """``text``, a sweep's or a CLI's output, printed ``epoch dispatch:
    <want>...`` once."""
    lines = [ln for ln in text.splitlines() if ln.startswith("epoch dispatch: ")]
    check(len(lines) == 1 and lines[0].startswith(f"epoch dispatch: {want}"), f"{name}: printed {lines}")


def _results_equal(a, b) -> bool:
    """Two ensemble results bit for bit equal: the final state (params,
    moments, counts), best params, criteria and epochs, history, EMA."""
    return (_states_equal(a.state, b.state) and _trees_equal(a.best_params, b.best_params)
            and np.array_equal(a.best_crit, b.best_crit) and np.array_equal(a.best_epoch, b.best_epoch)
            and all(np.array_equal(a.history[k], b.history[k]) for k in a.history)
            and (a.ema_params is None) == (b.ema_params is None)
            and (a.ema_params is None or _trees_equal(a.ema_params, b.ema_params)))


def _sweep_config(dataset: str, data_dir: str, backend: str, refit: int):
    """The sweep CLI's config for ``dataset`` at one epoch beyond epoch 0,
    as ``sweep.run`` builds it from ``--num-epochs 1 --ode-backend backend``
    (CVS on the generated data, proc and challenge on --data-seed 12's
    fold) and ``--prior-refit-epochs refit``."""
    cfg = sweep.load_base_config(dataset)
    cfg.num_epochs, cfg.ode_backend, cfg.prior_refit_epochs = 1, backend, refit or None
    if dataset == "cvs":
        cfg.data_path = data_dir
    else:
        cfg.data_seed = 12
    return cfg


def phase_sweep_graphs(device, data_dir: str, rehearse: bool, smi: str, paths: dict) -> dict:
    """The sweeps' epochs replayed as CUDA graphs (train/ensemble.py: the
    stacked dual step, the members' val ELBO, the prior refit's update),
    held against eager on SWEEP_GRAPH_CASES at full width, two epochs each:
    sweep.train_ensemble replayed (fresh captures), in 1-epoch chunks and,
    where the seeds split, in member groups of SWEEP_GROUP, each bit for bit
    its eager run (state, moments, counts, best params, criteria and epochs,
    history) with the same launches. Then, median of GRAPH_REPEATS, host
    clock to a synchronize, eager and replayed: the stacked dual step (an
    epoch of it over its steps) at the case's S and, at CVS, at S = 1, a
    sweep epoch (run_chunk: the steps, the val ELBO, the host's selection)
    and a refit step (the refit over its steps); each graph's capture time
    and pool; and a traced epoch of stacked steps each way (device busy
    time, idle share, host launching calls a step). In a rehearsal the
    graphs' plain version runs."""
    graphed = "plain" if rehearse else None
    n = 2 if rehearse else GRAPH_REPEATS
    out = {}
    for dataset, backend, seeds, refit in SWEEP_GRAPH_CASES:
        case, t0 = f"sweep graphs {dataset} {backend}", time.perf_counter()
        seeds = [12, 13] if rehearse else sweep.parse_seeds(seeds)
        cfg = _sweep_config(dataset, data_dir, backend, refit)
        members = [sweep.prepare_member(dataset, cfg, seed, device) for seed in seeds]
        S, kernels = len(members), STACKED[backend]
        for memo in SWEEP_MEMOS.values():
            memo.clear()  # fresh captures: their times

        def train(name, **kw):
            return counted(paths, f"{case} {name}", kernels, rehearse, lambda: printed(
                lambda: sweep.train_ensemble(members, device=device, **kw)))

        eager, text = train("eager", dispatch="eager")
        check_dispatch(f"{case} eager", text, "eager")
        replays, t0_ns = graphs.Graph.replays, time.perf_counter_ns()
        got, text = train("replayed", dispatch=graphed)
        check_dispatch(f"{case} replayed", text, "plain" if rehearse else "cuda graph")
        check(rehearse or graphs.Graph.replays > replays, f"{case}: no CUDA graph replayed")
        rec = {"S": S, "steps": int(members[0]["mask"].shape[0]), "epochs": int(members[0]["perms"].shape[0]),
               "refit_epochs": refit, "replays": graphs.Graph.replays - replays,
               "capture_ms": _captures_since(t0_ns)}
        checks = [("replayed", eager, got)]
        checks.append(("1-epoch chunks", eager, train("replayed chunks", dispatch=graphed, chunk_epochs=1)[0]))
        if S > SWEEP_GROUP and S % SWEEP_GROUP == 0:
            checks.append((f"groups of {SWEEP_GROUP}", train("eager groups", dispatch="eager",
                                                             member_group=SWEEP_GROUP)[0],
                           train("replayed groups", dispatch=graphed, member_group=SWEEP_GROUP)[0]))
        for what, ref, run in checks:
            check(_results_equal(ref, run), f"{case} {what}: differs from eager")
        for a, b in (("eager", "replayed"), ("eager", "replayed chunks"), ("eager groups", "replayed groups")):
            if f"{case} {b}" in paths:
                check(paths[f"{case} {a}"] == paths[f"{case} {b}"], f"{case} {b}: launches differ from {a}")
        print(f"== {case} x {S}: replayed, in 1-epoch chunks{' and in groups' if len(checks) > 2 else ''} bit "
              f"for bit eager, launches equal ({paths[f'{case} eager']})", flush=True)

        def timed(group, dispatch, whole: bool):
            """One runner's medians over ``group``, each after a warm-up call
            (which captures): its stacked step and, if ``whole``, a sweep
            epoch, a refit step and a traced epoch of stacked steps."""
            runner, inp, shared = sweep.prepare_run(group, device=device, dispatch=dispatch)
            split = {k: torch.as_tensor(v, device=device) for k, v in inp["train_splits"].items()}
            perms = torch.as_tensor(inp["perms"], device=device).long()
            mask = torch.as_tensor(inp["mask"], device=device)
            batches, steps = ensemble._epoch_batches(split, perms[:, 0], shared), mask.shape[0]
            fills = {"aux_mult": float(inp["aux_mult"][0, 0])}
            lr_sched = None if inp["lr_sched"] is None else inp["lr_sched"][:, :1]
            if lr_sched is not None:
                fills["lr_scale"] = float(lr_sched[0, 0])
            state = [inp["states"]]
            carry = runner.init_carry(inp["states"], inp["eval_seeds"])

            def epoch():
                state[0] = runner.train_epoch(state[0], batches, mask, fills)[0]

            def sweep_epoch():
                runner.run_chunk(carry, inp["train_splits"], inp["val_stacks"], inp["perms"][:, :1], inp["mask"],
                                 inp["aux_mult"][:, :1], lr_sched, [0])

            def refit():
                runner.refit(inp["states"].params, inp["eval_seeds"], inp["train_splits"], inp["refit_perms"],
                             inp["mask"])

            refits = 0 if inp["refit_perms"] is None else inp["refit_perms"].shape[1]
            t = {}
            for name, fn, per in (("step_ms", epoch, steps), ("sweep_epoch_ms", sweep_epoch, whole),
                                  ("refit_step_ms", refit, whole * steps * refits)):
                if per:
                    fn()
                    t[name] = _median_ms(fn, n, device) / per
            if whole and not rehearse:
                t["trace"] = _trace_epochs(epoch, 1, steps)
            return t

        t1 = time.perf_counter()
        for width, group in ((1, members[:1]), (S, members)):
            if width == S or dataset == "cvs":
                for way, dispatch in (("eager", "eager"), ("replayed", graphed)):
                    rec[f"S={width} {way}"] = timed(group, dispatch, width == S)
        rec["case_s"] = time.perf_counter() - t0
        rec["held_s"], rec["timed_s"] = t1 - t0, rec["case_s"] - (t1 - t0)
        out[f"{dataset} {backend}"] = rec
        print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)
    return out


# Phase 14: serving's predict functions and the eval functions replayed as
# CUDA graphs (serve.make_predict_fns, svi.make_eval_fns), held against
# eager: the backends of the served requests at CVS and their forward
# kernels, and the workloads served through serve.main on semilinear_fused
SERVE_GRAPH_BACKENDS = {"semilinear_fused": ("K2",), "semilinear": ("K1",)}
BANDS = 200  # the config's draws a mode (proc's num_samples)
BANDS_TRACED = 20  # draws a mode in the traced band dump


@contextlib.contextmanager
def forced_dispatch(dispatch):
    """svi.epoch_dispatch answering ``dispatch`` (None: as it is), which
    serve.main's predict functions take: its eager reference on the card,
    and the graphs' plain version in a rehearsal."""
    real = svi.epoch_dispatch
    if dispatch is not None:
        svi.epoch_dispatch = lambda spec, device, reduce=None: dispatch
    try:
        yield
    finally:
        svi.epoch_dispatch = real


def _stats_equal(a, b) -> bool:
    """Two driver.EvalStats (or pairs of them) bit for bit equal."""
    if isinstance(a, tuple):
        return all(_stats_equal(x, y) for x, y in zip(a, b))
    return (a.elbo == b.elbo and a.l1 == b.l1 and a.label_metrics == b.label_metrics
            and sorted(a.recon) == sorted(b.recon) and all(np.array_equal(a.recon[k], b.recon[k]) for k in a.recon))


def _outputs_equal(a, b) -> bool:
    """Two served outputs (dicts of arrays or tensors) bit for bit equal."""
    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    return sorted(a) == sorted(b) and all(np.array_equal(host(a[k]), host(b[k])) for k in a)


def _held_replays(paths: dict, name: str, kernels, rehearse: bool, eager_fn, graph_fn, same, calls: int = 3) -> int:
    """``eager_fn()`` once and ``graph_fn()`` ``calls`` times (the graph's
    eager warm-up, its capture and replay, replays), each counted: every
    call's output bit for bit the eager one (``same``), its launches the
    eager call's. Returns the replays."""
    ref = counted(paths, f"{name} eager", kernels, rehearse, eager_fn)
    replays = graphs.Graph.replays
    for call in range(calls):
        got = counted(paths, f"{name} replayed {call}", kernels, rehearse, graph_fn)
        check(same(ref, got), f"{name} call {call}: the replayed output differs from eager")
        check(paths[f"{name} eager"] == paths[f"{name} replayed {call}"], f"{name} call {call}: launches differ")
    n = graphs.Graph.replays - replays
    check(rehearse or n >= calls - 1, f"{name}: {n} CUDA graph replays in {calls} calls")
    return n


def _timed_both(device, rehearse: bool, eager_fn, graph_fn, trace_eager=None, trace_graph=None) -> dict:
    """Median of GRAPH_REPEATS, host clock to a synchronize, eager and
    replayed, and one torch.profiler trace each way of GRAPH_REPEATS calls,
    or of one call of ``trace_eager`` and ``trace_graph`` where given (the
    device's busy time and idle share a call; on the card)."""
    n = 2 if rehearse else GRAPH_REPEATS
    rec = {"eager_ms": _median_ms(eager_fn, n, device), "replayed_ms": _median_ms(graph_fn, n, device)}
    if not rehearse:
        traced = 1 if trace_eager else n  # the calls traced: a request is a few ms
        rec["trace_eager"] = _trace_epochs(trace_eager or eager_fn, traced, 1)
        rec["trace_replayed"] = _trace_epochs(trace_graph or graph_fn, traced, 1)
    return rec


def _captures_since(t0_ns: int) -> list:
    """The host time of each CUDA graph capture since ``t0_ns``
    (``time.perf_counter_ns``), in ms: its ``graph.capture`` span."""
    return [(end - start) / 1e6 for name, start, end, _, _ in profiling.SPANS
            if name == "graph.capture" and end >= t0_ns]


def phase_served_graphs(device, workdir: str, data_dir: str, ckpts, rehearse: bool, smi: str, paths: dict) -> dict:
    """Phase 14 (module docstring): the served and eval paths replayed as
    CUDA graphs against eager, each bit for bit with equal launches, then
    timed eager and replayed. In a rehearsal the graphs' plain version runs."""
    t_phase = time.perf_counter()
    graphed = "plain" if rehearse else None
    want = "plain" if rehearse else "cuda graph"
    out = {}

    # posterior requests at CVS B = 100 and the tiled B = 16,411 on K2 and
    # K1; the prior and the classifier at B = 100
    for backend, kernels in SERVE_GRAPH_BACKENDS.items():
        spec, params, times, splits = serve.load_model("cvs", ckpts[0], _config(data_dir, backend), device)
        eager = serve.make_predict_fns(spec, times, device, dispatch="eager")
        replayed = serve.make_predict_fns(spec, times, device, dispatch=graphed)
        check(replayed[0].dispatch == replayed[1].dispatch == want, f"predict dispatch {replayed[0].dispatch}")
        test = splits["test"]
        for B in (test["observations"].shape[0], 64 if rehearse else BIG_B):
            case = f"served cvs {backend} B={B}"
            idx = np.arange(B) % test["observations"].shape[0]
            batch = {k: torch.as_tensor(v[idx], device=device) for k, v in test.items()}
            batch["sample_id"] = torch.arange(B, device=device)
            svi._EVAL_FN_GRAPHS.clear()  # fresh captures: their times
            t0_ns = time.perf_counter_ns()
            rec = {"replays": _held_replays(paths, f"{case} posterior", kernels, rehearse,
                                            lambda: eager[0](params, 3, batch, True),
                                            lambda: replayed[0](params, 3, batch, True), _outputs_equal)}
            rec["capture_ms"] = _captures_since(t0_ns)
            if B == test["observations"].shape[0]:
                _held_replays(paths, f"{case} prior", kernels, rehearse, lambda: eager[0](params, 4, batch, False),
                              lambda: replayed[0](params, 4, batch, False), _outputs_equal)
                obs = batch["observations"]
                _held_replays(paths, f"{case} classify", (), rehearse, lambda: eager[1](params, 5, obs),
                              lambda: replayed[1](params, 5, obs), _outputs_equal)
            rec.update(_timed_both(device, rehearse, lambda: eager[0](params, 0, batch, True),
                                   lambda: replayed[0](params, 0, batch, True)))
            out[case] = rec
            print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)

    # serve.main, eager and replayed: CVS (test split, 100), proc (val fold,
    # 78) and challenge (val fold, 7) on semilinear_fused, the ensemble mean
    # of two checkpoints with --classify, posterior and prior
    for wl in ("cvs", "proc", "challenge"):
        cfg = _config(data_dir, "semilinear_fused") if wl == "cvs" else _workload_config(wl, "semilinear_fused")
        if wl == "cvs":
            members = ckpts
        else:
            spec = serve._build(wl, cfg, device)[0]
            members = []
            for seed in (0, 1):
                members.append(os.path.join(workdir, f"served-graphs-{wl}-{seed}.npz"))
                checkpoint.save(members[-1], params_to_jax(init_params(spec, seed, device=device)))
        for prior in (False, True):
            case = f"served main {wl} {'prior' if prior else 'posterior'}"
            argv = ["--dataset", wl, "--checkpoint", *members, "--classify", "--device", str(device)]
            argv += ["--prior"] if prior else []

            def main_run(dispatch, tag):
                with forced_dispatch(dispatch):
                    return printed(lambda: serve.main(
                        argv + ["--output", os.path.join(workdir, f"{case.replace(' ', '-')}-{tag}.npz")],
                        config=cfg.copy()))

            ref, text = counted(paths, f"{case} eager", ("K2",), rehearse, lambda: main_run("eager", "eager"))
            check(text.count("predict dispatch: eager\n") == 1, f"{case} eager: printed {text!r}")
            replays = graphs.Graph.replays
            got, text = counted(paths, f"{case} replayed", ("K2",), rehearse, lambda: main_run(graphed, "replayed"))
            check(text.count(f"predict dispatch: {want}\n") == 1, f"{case}: printed {text!r}")
            check(rehearse or graphs.Graph.replays > replays, f"{case}: no CUDA graph replayed")
            check(_outputs_equal(ref, got), f"{case}: serve.main replayed differs from eager")
            check(paths[f"{case} eager"] == paths[f"{case} replayed"], f"{case}: launches differ from eager")
            out[case] = {"replays": graphs.Graph.replays - replays, "mu_50": list(got["mu_50"].shape)}
            print(f"== {case}: two checkpoints with --classify through serve.main, replayed bit for bit eager, "
                  f"launches equal; {json.dumps(out[case])}", flush=True)
        if wl != "cvs":  # a request at the workload's val fold, timed
            spec, params, times, splits = serve.load_model(wl, members[0], cfg, device)
            eager = serve.make_predict_fns(spec, times, device, dispatch="eager")
            replayed = serve.make_predict_fns(spec, times, device, dispatch=graphed)
            batch = {k: torch.as_tensor(v, device=device) for k, v in splits["val"].items()}
            case = f"served {wl} semilinear_fused B={batch['observations'].shape[0]}"
            svi._EVAL_FN_GRAPHS.clear()
            t0_ns = time.perf_counter_ns()
            rec = {"replays": _held_replays(paths, f"{case} posterior", ("K2",), rehearse,
                                            lambda: eager[0](params, 3, batch, True),
                                            lambda: replayed[0](params, 3, batch, True), _outputs_equal)}
            rec["capture_ms"] = _captures_since(t0_ns)
            rec.update(_timed_both(device, rehearse, lambda: eager[0](params, 0, batch, True),
                                   lambda: replayed[0](params, 0, batch, True)))
            out[case] = rec
            print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)

    # the final test evaluation at CVS (eval_split over the test split,
    # posterior and prior) through the eval functions
    cfg = _config(data_dir, "semilinear_fused")
    spec, params, times, splits = serve.load_model("cvs", ckpts[0], cfg, device)
    ts = torch.as_tensor(times, device=device)
    eager_fns, graph_fns = svi.make_eval_fns(spec, ts, dispatch="eager"), svi.make_eval_fns(spec, ts, dispatch=graphed)
    check({f.dispatch for f in graph_fns} == {want}, f"eval dispatch {graph_fns[0].dispatch}")
    svi._EVAL_FN_GRAPHS.clear()
    case = "final_test_eval cvs semilinear_fused"

    def final(fns):
        return final_test_eval(spec, params, 6, splits["test"], fns, cfg.mini_batch_size)

    t0_ns = time.perf_counter_ns()
    rec = {"replays": _held_replays(paths, case, ("K2",), rehearse, lambda: final(eager_fns),
                                    lambda: final(graph_fns), _stats_equal)}
    rec["capture_ms"] = _captures_since(t0_ns)
    rec.update(_timed_both(device, rehearse, lambda: final(eager_fns), lambda: final(graph_fns)))
    out[case] = rec
    print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)

    # proc's sample bands: BANDS draws a mode, posterior and prior
    pcfg = _workload_config("proc", "semilinear_fused")
    pspec, psplits, ptimes = serve._build("proc", pcfg, device)
    pts = torch.as_tensor(np.asarray(ptimes, dtype=np.float32), device=device)
    pparams = init_params(pspec, 0, device=device)
    p_eager, p_graph = svi.make_eval_fns(pspec, pts, dispatch="eager"), svi.make_eval_fns(pspec, pts, dispatch=graphed)
    draws = 2 if rehearse else BANDS
    svi._EVAL_FN_GRAPHS.clear()
    case = f"sample bands proc semilinear_fused x{draws}"
    dirs = {}

    def bands(fns, tag, n=draws):
        dirs[tag] = os.path.join(workdir, f"bands-{tag}")
        os.makedirs(dirs[tag], exist_ok=True)
        training_challenge.dump_sample_bands(dirs[tag], fns[2], pparams, fold_seed(7, "samples"), psplits["val"], n,
                                        device)

    counted(paths, f"{case} eager", ("K2",), rehearse, lambda: bands(p_eager, "eager"))
    replays, t0_ns = graphs.Graph.replays, time.perf_counter_ns()
    counted(paths, f"{case} replayed", ("K2",), rehearse, lambda: bands(p_graph, "replayed"))
    check(paths[f"{case} eager"] == paths[f"{case} replayed"], f"{case}: launches differ from eager")
    rec = {"replays": graphs.Graph.replays - replays, "arrays": _bit_equal(dirs["eager"], dirs["replayed"], case)}
    check(rehearse or rec["replays"] >= 2 * draws - 2, f"{case}: {rec['replays']} replays")
    rec["capture_ms"] = _captures_since(t0_ns)
    traced = 2 if rehearse else BANDS_TRACED
    rec.update(_timed_both(device, rehearse, lambda: bands(p_eager, "eager"), lambda: bands(p_graph, "replayed"),
                           lambda: bands(p_eager, "eager", traced), lambda: bands(p_graph, "replayed", traced)))
    rec["traced_draws"] = traced
    out[case] = rec
    print(f"{case}: the bands replayed bit for bit eager ({rec['arrays']} arrays), launches equal; "
          f"{json.dumps(rec)} ({smi})", flush=True)

    # the sweep's selection prior L1 of a two-member CVS sweep
    scfg = _sweep_config("cvs", data_dir, "semilinear_fused", 0)
    members = [sweep.prepare_member("cvs", scfg, seed, device) for seed in (12, 13)]
    mts = torch.as_tensor(members[0]["times"], device=device)
    s_eager = svi.make_eval_fns(members[0]["spec"], mts, dispatch="eager")
    s_graph = svi.make_eval_fns(members[0]["spec"], mts, dispatch=graphed)
    svi._EVAL_FN_GRAPHS.clear()
    case = "selection_prior_l1 cvs x2"

    def selection(fns):
        return [sweep.selection_prior_l1(m, m["params"], fns[2]) for m in members]

    rec = {"replays": _held_replays(paths, case, ("K2",), rehearse, lambda: selection(s_eager),
                                    lambda: selection(s_graph), lambda a, b: a == b)}
    rec.update(_timed_both(device, rehearse, lambda: selection(s_eager), lambda: selection(s_graph)))
    rec["l1"] = selection(s_graph)
    out[case] = rec
    print(f"{case}: {json.dumps(rec)} ({smi})", flush=True)
    svi._EVAL_FN_GRAPHS.clear()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"== phase 14 took {out['wall_s']:.1f} s ({smi})", flush=True)
    return out

def phase_trace(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """A CVS run on semilinear_fused with --profile-dir: the trace of epoch 1
    parses, and its device events name K2's and K3's kernels."""
    prof = os.path.join(workdir, "profile")
    counted(paths, "trace cvs semilinear_fused", TRAINING["semilinear_fused"], rehearse, lambda: training_cvs.main([
        "--num-epochs", "1", "--no-plot", "--ode-backend", "semilinear_fused", "--data-path", data_dir,
        "--profile-dir", prof, "--results-root", os.path.join(workdir, "trace"), "--device", str(device)]),
        replayed=True)
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    found = {key: sum(n for k, n in kernels.items() if pattern in k) for key, pattern in TRACE_NAMES.items()}
    print(f"trace {name}: {len(events)} events, {sum(kernels.values())} device kernel events of "
          f"{len(kernels)} names; K2 {found['K2']}, K3 {found['K3']} (launches in the traced run: "
          f"{paths['trace cvs semilinear_fused']})", flush=True)
    if not rehearse:
        check(all(found.values()), f"the trace names no device event of {TRACE_NAMES}: {sorted(kernels)[:20]}")


def phase_native(rehearse: bool, smi: str):
    """Where g++ is on PATH the port's library must build (from the source,
    again if an earlier phase built it); its parse of the six proc files
    equals the csv parse element for element, and its pack equals the numpy
    gather at proc's training split. Host time of a parse of the six files
    each way: the least of three passes, the two ways in turns."""
    from structured_latent_odes_tpu_torch import native
    from structured_latent_odes_tpu_torch.data import proc as proc_data

    if native.compiler() is None:
        print("native: no C++ compiler on PATH; the port parses with csv (nothing built)", flush=True)
        return
    if os.path.exists(native.LIBRARY):
        os.remove(native.LIBRARY)  # a process that loaded it keeps its mapping
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    check(native.lib() is not None, "native: the library built but does not load")
    cfg = LOADERS["proc"]()
    files = [os.path.join(cfg.data_path, f) for f in cfg.data.files]
    parsed, ms = {}, {True: [], False: []}
    for _ in range(3):
        for use_native in (True, False):
            t0 = time.perf_counter()
            parsed[use_native] = [proc_data.parse_file(p, cfg.data, use_native=use_native) for p in files]
            ms[use_native].append((time.perf_counter() - t0) * 1e3)
    for p, a, b in zip(files, parsed[True], parsed[False]):
        check(len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b)),
              f"native parse of {p} differs from the csv parse")
    splits, _ = proc_data.build_splits(cfg)
    train = splits["train"]
    n = train["observations"].shape[0]
    sel = np.concatenate([np.random.RandomState(0).permutation(n), np.zeros(-n % 36, dtype=int)])
    for k, v in train.items():
        check(np.array_equal(native.pack_epoch_native(v, sel, len(sel)), v[sel].astype(np.float32)),
              f"native pack of proc train {k} differs from the numpy gather")
    print(f"native: {native.LIBRARY} built in {build_s:.2f} s; the six proc files parsed equal element for "
          f"element; host time of the six, least of 3 passes: native {min(ms[True]):.3f} ms, csv "
          f"{min(ms[False]):.3f} ms (passes {[round(t, 3) for t in ms[True]]} and "
          f"{[round(t, 3) for t in ms[False]]}; {smi}); pack of proc's training split ({n} rows) equal to the "
          f"numpy gather", flush=True)


def phase_pickles(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """The generated CVS data with its norm params as the reference's four
    torch.save pickles: build_splits from them equals the cvs.npz splits,
    and one epoch trained from each gives bit for bit the same artifacts."""
    ref = os.path.join(workdir, "cvs-pickles")
    os.makedirs(ref)
    with np.load(os.path.join(data_dir, "cvs.npz")) as z:
        d = {k: z[k] for k in z.files}
    torch.save({"train": torch.from_numpy(d["train_obs"]), "test": torch.from_numpy(d["test_obs"])},
               os.path.join(ref, "processed_data.pkl"))
    for split in ("train", "test"):
        torch.save({"i_ext": d[f"{split}_iext"], "r_tpr_mod": d[f"{split}_rtpr"]},
                   os.path.join(ref, f"{split}_params_data.pkl"))
    torch.save({k[len("norm_"):]: v for k, v in d.items() if k.startswith("norm_")},
               os.path.join(ref, "data_norm_params.pkl"))
    from_npz, from_pkl = _config(data_dir, "semilinear_fused"), _config(data_dir, "semilinear_fused")
    from_pkl.reference_data_dir = ref
    a, b = training_cvs.build_splits(from_npz, device)[0], training_cvs.build_splits(from_pkl, device)[0]
    for name in a:
        for k in a[name]:
            check(a[name][k].dtype == b[name][k].dtype and np.array_equal(a[name][k], b[name][k]),
                  f"pickles: split {name} {k} differs from the cvs.npz split")
    runs = {}
    for tag, extra in (("cvs.npz", ["--data-path", data_dir]), ("pickles", ["--reference-data-dir", ref])):
        runs[tag] = counted(paths, f"pickles: one epoch from {tag}", TRAINING["semilinear_fused"], rehearse,
                            lambda: training_cvs.main(["--num-epochs", "0", "--no-plot", "--ode-backend",
                                                       "semilinear_fused", "--device", str(device), "--results-root",
                                                       os.path.join(workdir, f"pickles-{tag}")] + extra))
    n = _bit_equal(runs["cvs.npz"]["out_dir"], runs["pickles"]["out_dir"], "pickles against cvs.npz")
    print(f"pickles: splits equal to cvs.npz's; one epoch from each: {n} arrays bit for bit equal", flush=True)


def phase_samplers(device, rehearse: bool):
    """SAMPLER_DRAWS draws of each of the three samplers on the card: means
    and variances within 5 standard errors; the uniform words bit for bit
    the CPU's."""
    from structured_latent_odes_tpu_torch import prob

    n = 4096 if rehearse else SAMPLER_DRAWS
    ids = torch.arange(n, device=device)
    words = prob.uniform_words_ps(11, "check", ids, 3)
    check(torch.equal(words.cpu(), prob.uniform_words_ps(11, "check", ids.cpu(), 3)),
          "sampler: the uniform words differ from the CPU's")

    def within(name, x, mean, var, m4):
        x = x.double()
        se_mean = math.sqrt(var / n)
        se_var = math.sqrt((m4 - (n - 3) / (n - 1) * var ** 2) / n)
        z = (abs(float(x.mean()) - mean) / se_mean, abs(float(x.var()) - var) / se_var)
        print(f"sampler {name}: mean {float(x.mean()):.6f} (want {mean:.6f}), variance {float(x.var()):.6f} "
              f"(want {var:.6f}): {z[0]:.2f} and {z[1]:.2f} standard errors", flush=True)
        check(max(z) <= 5, f"sampler {name}: more than 5 standard errors off")

    ones = torch.ones(n, 1, device=device)
    within("laplace(1.5, 2)", prob.sample_laplace(1, "lap", ids, 1.5 * ones, 2.0 * ones), 1.5, 8.0, 24 * 16.0)
    p = 0.3
    within("bernoulli(0.3)", prob.sample_bernoulli(2, "bern", ids, p * ones), p, p * (1 - p), p * (1 - p) * (
        (1 - p) ** 3 + p ** 3))
    probs = torch.tensor([0.1, 0.6, 0.3], device=device).expand(n, 3)
    cat = prob.sample_onehot_categorical(3, "cat", ids, probs)
    check(torch.equal(cat.sum(-1), torch.ones(n, device=device)), "sampler: categorical draws are not one-hot")
    for j, q in enumerate((0.1, 0.6, 0.3)):
        within(f"categorical class {j} ({q})", cat[:, j], q, q * (1 - q), q * (1 - q) * ((1 - q) ** 3 + q ** 3))


def phase_plot_check(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """Plotting on: where matplotlib or scikit-learn is missing the CVS run
    must raise naming it and --no-plot before any kernel launches; where both
    are there, one epoch's plots are drawn."""
    from structured_latent_odes_tpu_torch.utils import plotting

    missing = []
    for name in plotting.PACKAGES:
        try:
            __import__(name)
        except ImportError:
            missing.append(name)
    root = os.path.join(workdir, "plots")
    argv = ["--num-epochs", "0", "--ode-backend", "semilinear_fused", "--data-path", data_dir, "--results-root", root,
            "--device", str(device)]
    if missing:
        def run():
            try:
                training_cvs.main(argv)
            except ImportError as e:
                return str(e)
            fail(f"plotting: a run without --no-plot did not raise though {missing} cannot be imported")

        msg = counted(paths, "plots without their packages", (), rehearse, run)
        check(plotting.PACKAGES[missing[0]] in msg and "--no-plot" in msg, f"plotting: the error {msg!r}")
        print(f"plotting: {missing} not importable here; the run raised before its first step: {msg}", flush=True)
        return
    out = counted(paths, "plots cvs semilinear_fused", TRAINING["semilinear_fused"], rehearse,
                  lambda: training_cvs.main(argv))
    pngs = sorted(f for f in os.listdir(out["out_dir"]) if f.endswith(".png"))
    check({"val_0_post.png", "z_TSNE_0.png"} <= set(pngs), f"plotting: {pngs}")
    print(f"plotting: matplotlib and scikit-learn here; one epoch drew {pngs}", flush=True)


# Phase 10: data, time and member parallelism over ranks (ROADMAP A17, and
# C6 at proc and challenge). The
# card's machine has one H100 and NCCL refuses two ranks on one GPU, so two
# spawned ranks share cuda:0 over gloo (named explicitly), and NCCL runs as a
# group of one rank. The ranks start once and run every case; the parent
# computes the one-device references. Bounds: the data-parallel step against
# one device, loss rtol 1e-5, params rtol 1e-4 and atol 1e-5
# (tests/test_parallel.py of the JAX package), and the summed gradients its
# updates took within 1e-5 of each leaf's largest, at least 1 (the port's
# gradient bound against JAX; Adam's update hardly moves when every
# gradient is scaled alike, so the params alone would not show a mean taken
# for a sum); the time-parallel solve's
# values atol 1e-5 (tests/test_timepar.py, where |x| stays below 1) plus
# 1e-5 relative, K2's rule above (at random weights |x| reaches 75, and the
# blocked scan's pA * carry + pB rounds apart from the sequential recurrence
# by float32 roundoff of |x|: 3.8e-5 at |x| = 75 on the CPU), the recurrence
# of LONG_T steps (|x| below 1) atol 1e-5; its gradients and the step's
# params rtol 1e-3 and atol 1e-4 (tests/test_timepar.py); a member-sharded
# sweep against the unsharded one run in member groups of a rank's size
# (each rank's stacked step holds the same members): bit for bit, and within
# criterion rtol 1e-6,
# best epochs equal, params rtol 1e-5 and atol 1e-7 (the JAX package's
# member-sharded bound, tests/test_ensemble.py) and Adam's moments, sums of
# gradients in the hundreds, within 1e-5 of each leaf's largest; and against
# the unsharded stack of all members within phase 7's member bound, rtol
# 2e-4 and atol 1e-6, since batched products round differently at another
# member count. The NCCL group of one is held bit for bit.
RANKS_LABEL = "two ranks sharing one card over gloo"
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-5, 1e-4, 1e-5
TP_VALUE_ATOL, TP_VALUE_RTOL, TP_RTOL, TP_ATOL = 1e-5, 1e-5, 1e-3, 1e-4
DP_GRAD_TOL = 1e-5
ENS_RTOL, ENS_ATOL, ENS_CRIT_RTOL = 1e-5, 1e-7, 1e-6
STACKED_RTOL, STACKED_ATOL = 2e-4, 1e-6
RANK_STEPS = 5  # timed dual steps per case, after the counted one
GRAPH_STEPS = 4  # minibatches a replayed data-parallel epoch
# intra-op threads per rank, a limit on the host's load only (two ranks on
# the machine's 8 cores): since init_params' QR runs at one thread (nn/init.py),
# no result depends on it
RANK_THREADS = 4


def _np_tree(tree):
    """A copy of a tree of tensors in numpy (on the CPU a tensor's numpy()
    shares its memory, which a graph's next replay overwrites)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dual_step_ms(step, state, batch, n: int, device) -> float:
    """Median host time of ``n`` dual steps, each ending in a synchronise."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, _m = step(state, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _reduce_ms(step, state, batch, n: int, device) -> float:
    """Median over ``n`` dual steps of the host time each spends in the data
    group's sums (mesh.all_reduce_tree, both of a step's), each sum between
    synchronises: the collective's own time, with the step's queued work
    finished before it (the steps themselves run slower so)."""
    summed, spent = mesh_module.all_reduce_tree, []

    def timed(tree, group):
        _sync(device)
        t0 = time.perf_counter()
        out = summed(tree, group)
        _sync(device)
        spent[-1] += time.perf_counter() - t0
        return out

    mesh_module.all_reduce_tree = timed
    try:
        for _ in range(n):
            spent.append(0.0)
            state, _m = step(state, batch)
    finally:
        mesh_module.all_reduce_tree = summed
    return float(np.median(spent)) * 1e3


def _rank_world() -> int:
    return torch.distributed.get_world_size()


def _rank_card() -> str:
    """The device this rank's ``"cuda"`` resolves to, and the card's name."""
    if not torch.cuda.is_available():
        return "cpu"
    return f"{resolve_device('cuda')} {torch.cuda.get_device_name(torch.cuda.current_device())}"


def _rank_dp_step(c: dict):
    """On each rank of the data-parallel grid over ranks ``c['ranks']``
    (groups of ``c['group_backend']``, None: the world's), at workload
    ``c['workload']``: one dual step on
    this rank's rows, launches counted, with the summed main and aux
    gradients its updates took (what the data group's sum,
    mesh.all_reduce_tree, returned), then ``c['steps']`` timed and, with
    ``c['time_reduce']``, the time of their sums (:func:`_reduce_ms`). A
    rank outside the grid returns None."""
    grid = make_mesh(len(c["ranks"]), 1, ranks=c["ranks"], backend=c["group_backend"])
    if grid is None:
        return None
    device = resolve_device(c["device"])
    full_fp32()
    spec = _rank_spec(c["workload"], c["data_dir"], c["backend"])
    params = tree_map(lambda a: torch.as_tensor(a, device=device), c["params"])
    ts = torch.as_tensor(c["times"], device=device)
    init_state, step, _ = dp_train.make_dp_train_step(spec, ts, c["lr"], params, grid)
    batch = device_batch(shard_batch(grid, c["batch"]), device)
    state = init_state(params, c["seed"])
    seen, summed = [], mesh_module.all_reduce_tree
    mesh_module.all_reduce_tree = lambda tree, group: seen.append(summed(tree, group)) or seen[-1]
    zero_counts()
    try:
        new, mets = step(state, batch)
        _sync(device)
    finally:
        mesh_module.all_reduce_tree = summed
    counts = read_counts()
    out = {"params": _np_tree(new.params), "loss_main": float(mets["loss_main"]),
           "loss_aux": float(mets["loss_aux"]), "counts": counts, "rows": int(batch["mask"].shape[0]),
           "dispatch": svi.epoch_dispatch(spec, device, mesh_module.data_reduce(grid)),
           "grads": [_np_tree(seen[0]), _np_tree(seen[1][0])],
           "ms": _dual_step_ms(step, new, batch, c["steps"], device)}
    if c.get("time_reduce"):
        out["reduce_ms"] = _reduce_ms(step, new, batch, c["steps"], device)
    return out


def _rank_dp_graphs(c: dict):
    """On each rank of the data-parallel grid over ranks ``c['ranks']``
    (groups of ``c['group_backend']``, None: the world's), at workload
    ``c['workload']`` on ``c['backend']``: two training epochs over this
    rank's slice of the stacked epoch ``c['stack']`` from one state, then
    the eval epoch (posterior and prior, twice) over its slice of
    ``c['val']`` at their params, each way: eager, and as
    ``svi.epoch_dispatch`` picks for the data group's reduce
    (``c['graphed']``: 'plain' in a rehearsal), a CUDA graph over NCCL,
    which replays 2 * GRAPH_STEPS - 1 steps and each eval epoch's second
    call. Per way the params, Adam's moments, the per-step
    metrics, the statistics, the launches and the replays; then the median
    of ``c['steps']`` epochs each way a step (host clock to a synchronize)
    and, with ``c['trace']``, one replayed epoch traced (the NCCL kernels'
    device time a step among its numbers). A rank outside the grid returns
    None."""
    grid = make_mesh(len(c["ranks"]), 1, ranks=c["ranks"], backend=c["group_backend"])
    if grid is None:
        return None
    device = resolve_device(c["device"])
    full_fp32()
    spec = _rank_spec(c["workload"], c["data_dir"], c["backend"])
    params = tree_map(lambda a: torch.as_tensor(a, device=device), c["params"])
    ts = torch.as_tensor(c["times"], device=device)
    reduce = mesh_module.data_reduce(grid)
    stack = device_batch(shard_stacked(grid, c["stack"]), device)
    val = device_batch(shard_stacked(grid, c["val"]), device)
    steps = int(stack["mask"].shape[0])
    out = {"rows": int(stack["mask"].shape[1]), "reduce": [reduce.backend, reduce.capturable]}
    epochs = {}
    for way, dispatch in (("eager", "eager"), ("replayed", c["graphed"])):
        init_state, _, train_epoch = svi.make_train_step(spec, ts, c["lr"], params, reduce=reduce, dispatch=dispatch)
        eval_epoch = svi.make_eval_epoch(spec, ts, reduce=reduce, dispatch=dispatch)
        zero_counts()
        replays = graphs.Graph.replays
        state, mets = init_state(params, c["seed"]), []
        for _ in range(2):
            state, m = train_epoch(state, stack)
            mets.append(_np_tree(m))
        for _ in range(2):  # a graph's eager first call, then its capture and replay
            stats = [_np_tree(eval_epoch(state.params, 7, val, is_post)) for is_post in (True, False)]
        _sync(device)
        out[way] = {"params": _np_tree(state.params), "moments": _np_tree([state.opt.mu, state.opt.nu]),
                    "metrics": mets, "stats": stats, "counts": read_counts(), "replays": graphs.Graph.replays - replays,
                    "dispatch": [train_epoch.dispatch, eval_epoch.dispatch]}
        epochs[way] = train_epoch, state
    (e_epoch, e_state), (g_epoch, g_state) = epochs["eager"], epochs["replayed"]
    e_state = svi.own_state(e_state)
    out["step_ms"] = {"eager": _median_ms(lambda: e_epoch(e_state, stack), c["steps"], device) / steps,
                      "replayed": _median_ms(lambda: g_epoch(g_state, stack), c["steps"], device) / steps}
    if c.get("trace"):
        out["trace_replayed"] = _trace_epochs(lambda: g_epoch(g_state, stack), 1, steps)
    return out


def _rank_tp_case(c: dict):
    """On the ``c['grid']`` = (data, model) grid of the world, at workload
    ``c['workload']``, the horizon
    over the model ranks: the decoder ODE's solve on semilinear_timepar
    (values) and the main loss's gradients, both of the whole batch on every
    rank, then one counted dual step on this rank's data rows and timed
    ones; then the recurrence of ``c['long_T']`` steps through
    solve_affine_recurrence_timepar over the model ranks, its launches
    counted."""
    n_data, n_model = c["grid"]
    grid = make_mesh(n_data, n_model)
    device = resolve_device(c["device"])
    full_fp32()
    spec = _rank_spec(c["workload"], c["data_dir"], "semilinear", n_model)
    params = tree_map(lambda a: torch.as_tensor(a, device=device), c["params"])
    ts = torch.as_tensor(c["times"], device=device)
    batch = device_batch(c["batch"], device)
    rows = device_batch(shard_batch(grid, c["batch"]), device)
    out = {"dispatch": svi.epoch_dispatch(spec, device, mesh_module.data_reduce(grid))}
    with timepar.time_sharding(grid):
        zero_counts()
        with torch.no_grad():
            out["solve"] = solve_ode(spec.decoder.ode, params["decoder"]["ode"], torch.as_tensor(c["z"], device=device),
                                     ts).cpu().numpy()
        main_loss, _ = svi.make_losses(spec, ts)
        _, _, grads = svi.value_and_grad(main_loss, params, 7, batch)
        out["grads"] = _np_tree(grads)
        init_state, step, _ = dp_train.make_dp_train_step(spec, ts, c["lr"], params, grid)
        new, mets = step(init_state(params, c["seed"]), rows)
        _sync(device)
        out["counts"] = read_counts()
        out.update(params=_np_tree(new.params), loss_main=float(mets["loss_main"]),
                   loss_aux=float(mets["loss_aux"]), ms=_dual_step_ms(step, new, rows, c["steps"], device))
    A, B, x0 = (torch.as_tensor(a, device=device) for a in c["long"])
    zero_counts()
    t0 = time.perf_counter()
    xs = timepar.solve_affine_recurrence_timepar(A, B, x0, mesh=grid)
    _sync(device)
    out.update(long_ms=(time.perf_counter() - t0) * 1e3, long_counts=read_counts(), long=xs.cpu().numpy())
    return out


def _rank_sweep(argv, own_root: bool = False):
    """sweep.run in the ranks' group: rank 0's summary and stacked result,
    each rank's launches and CUDA graph replays, and the host time of the
    results' gather
    (train/ensemble.py::gather_results, one gather_object) with the pickled
    size of what this rank sent. With ``own_root`` each rank's
    ``--results-root`` is its own ``rank<r>`` directory below the given one,
    so that what each rank wrote can be told apart."""
    dist = torch.distributed
    if own_root:
        at = argv.index("--results-root") + 1
        argv = argv[:at] + [os.path.join(argv[at], f"rank{dist.get_rank()}")] + argv[at + 1:]
    gather, spent = dist.gather_object, {}

    def timed(obj, *args, **kwargs):
        spent["bytes"] = len(pickle.dumps(obj))
        t0 = time.perf_counter()
        out = gather(obj, *args, **kwargs)
        spent["s"] = time.perf_counter() - t0
        return out

    dist.gather_object = timed
    zero_counts()
    replays = graphs.Graph.replays
    try:
        run = sweep.run(sweep.parse_args(argv))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        dist.gather_object = gather
    return {"counts": read_counts(), "summary": None if run is None else run.summary,
            "result": None if run is None else run.result, "gather_s": spent.get("s"),
            "gather_bytes": spent.get("bytes"), "replays": graphs.Graph.replays - replays}


def _one_device_step(spec, params, batch, ts, lr: float, seed: int):
    """One dual step on one device: the state, metrics, the step, and the
    main and aux gradients its updates took (the ``reduce`` hook's input,
    recorded by a second step on the same inputs)."""
    init_state, step, _ = svi.make_train_step(spec, ts, lr, params)
    state, mets = step(init_state(params, seed), batch)
    seen = []
    init_rec, step_rec, _ = svi.make_train_step(spec, ts, lr, params, reduce=lambda tree: seen.append(tree) or tree)
    step_rec(init_rec(params, seed), batch)
    return state, mets, step, [seen[0], seen[1][0]]


def grad_ratio(got, ref) -> float:
    """The worst leaf's max |got - ref| over DP_GRAD_TOL times its largest
    |ref| (at least 1): <= 1 within tolerance."""
    return max(float((torch.as_tensor(g) - r.cpu()).abs().max()) / (DP_GRAD_TOL * max(float(r.abs().max()), 1.0))
               for g, r in zip(tree_leaves(got), tree_leaves(ref)))


def _hold_step(name: str, out: dict, ref_state, ref_mets, loss_rtol: float, rtol: float, atol: float,
               ref_grads=None) -> dict:
    """The worst loss error over its rtol, the worst param error over
    ``atol + rtol*|ref|`` and, given ``ref_grads``, the worst gradient
    error (:func:`grad_ratio`); fails past 1."""
    loss = max(abs(out[k] - float(ref_mets[k])) / (loss_rtol * abs(float(ref_mets[k])))
               for k in ("loss_main", "loss_aux"))
    par = max(ratio(torch.as_tensor(o), r.cpu(), atol, rtol)
              for o, r in zip(tree_leaves(out["params"]), tree_leaves(ref_state.params)))
    grads = 0.0 if ref_grads is None else max(grad_ratio(g, r) for g, r in zip(out["grads"], ref_grads))
    print(f"{name}: losses {out['loss_main']:.6f}, {out['loss_aux']:.6f}; loss error / tolerance {loss:.3e}, "
          f"params error / tolerance {par:.3e}" +
          ("" if ref_grads is None else f", summed main and aux gradients {grads:.3e}"), flush=True)
    check(loss <= 1.0 and par <= 1.0 and grads <= 1.0, f"{name}: disagrees with the one-device step")
    return {"loss": loss, "params": par, "grads": grads}


def _check_rank_counts(paths: dict, name: str, counts: dict, expected, rehearse: bool) -> None:
    paths[name] = counts
    print(f"launches {name}: {counts}", flush=True)
    hold_counts(name, counts, expected, rehearse)


# the workloads of phases 10 and 11: CVS at its training batch and horizon,
# proc and challenge as phase 6 runs them (WORKLOADS)
RANK_WORKLOADS = {"cvs": dict(spec=cvs_spec, train_b=TRAIN_B, T=86, D=5), **WORKLOADS}


def _rank_spec(wl: str, data_dir: str, backend: str, time_parallel: int = 0):
    """The spec of ``wl`` on ``backend``; with ``time_parallel`` above 1 on
    semilinear_timepar (models/zoo.py)."""
    cfg = _config(data_dir, backend) if wl == "cvs" else _workload_config(wl, backend)
    cfg.time_parallel = time_parallel
    w = RANK_WORKLOADS[wl]
    return w["spec"](cfg, n_time=w["T"])


class RankInputs:
    """What phases 10 and 11 hand their ranks at workload ``wl`` (``base``:
    the workload's params of seed 0, its first training batch of ``B`` rows,
    its time grid, the step's seed and lr), the recurrence of ``long_t``
    steps at its ODE state width and a batch of latents for the
    time-parallel cases, and the one-device references on ``device``: a dual
    step per backend, its time, and the time-parallel cases' solve,
    main-loss gradients and recurrence."""

    def __init__(self, device, data_dir: str, rehearse: bool, wl: str):
        self.wl, w = wl, RANK_WORKLOADS[wl]
        cfg = _config(data_dir, "semilinear") if wl == "cvs" else _workload_config(wl, "semilinear")
        spec, splits, times = serve._build(wl, cfg, device)
        check(len(times) == w["T"] and spec.decoder.ode.ode_state_dim == w["D"], f"{wl}: the rank inputs' shapes")
        self.B = B = 8 if rehearse and wl == "cvs" else w["train_b"]
        batch = {k: v[0] for k, v in stacked_minibatches(splits["train"], B, shuffle=False).items()}
        times = np.asarray(times, dtype=np.float32)
        self.ts = ts = torch.as_tensor(times, device=device)
        lr, seed = cfg.learning_rate, fold_seed(12, "train")
        self.params = params = init_params(spec, 0, device=device)
        self.dbatch = dbatch = device_batch(batch, device)
        self.steps = 2 if rehearse else RANK_STEPS
        self.base = dict(params=_np_tree(params), batch=batch, times=times, seed=seed, lr=lr, data_dir=data_dir,
                         steps=self.steps, workload=wl)
        # the replayed epochs' inputs: the first GRAPH_STEPS minibatches of the
        # training split, and the val split, at B
        self.stack = {k: v[:GRAPH_STEPS] for k, v in stacked_minibatches(splits["train"], B, shuffle=False).items()}
        self.val = stacked_minibatches(splits["val"], B, shuffle=False)
        self.long_t = 256 if rehearse else LONG_T
        D = w["D"]
        gen = torch.Generator().manual_seed(10)
        self.long = ((torch.rand((B, self.long_t - 1, D), generator=gen) * 0.05 + 0.95),
                     (torch.rand((B, self.long_t - 1, D), generator=gen) - 0.5) * 0.02,
                     torch.rand((B, D), generator=gen))
        self.z = torch.randn((B, spec.latent_dim), generator=gen)
        self.refs = {b: _one_device_step(_rank_spec(wl, data_dir, b), params, dbatch, ts, lr, seed)
                     for b in ("semilinear", "semilinear_fused")}
        self.ref_ms = {b: _dual_step_ms(r[2], r[0], dbatch, self.steps, device) for b, r in self.refs.items()}
        with torch.no_grad():
            self.ref_solve = solve_ode(spec.decoder.ode, params["decoder"]["ode"], self.z.to(device), ts).cpu()
        _, _, self.ref_grads = svi.value_and_grad(svi.make_losses(spec, ts)[0], params, 7, dbatch)
        self.ref_long = recurrence.affine_scan(*(t.to(device) for t in self.long)).cpu()

    def tp_case(self, pool_device: str, grid) -> dict:
        return dict(self.base, device=pool_device, grid=grid, z=self.z.numpy(), long=[t.numpy() for t in self.long])


def _one_device_epochs(inp: RankInputs, backend: str, dispatch="eager") -> dict:
    """What :func:`_rank_dp_graphs` returns of a way, on one device without
    ranks: two training epochs over ``inp.stack`` and the eval epoch over
    ``inp.val`` at ``dispatch`` (None: a CUDA graph on the card); and the
    median of ``inp.steps`` epochs a step."""
    spec = _rank_spec(inp.wl, inp.base["data_dir"], backend)
    device = inp.ts.device
    stack, val = device_batch(inp.stack, device), device_batch(inp.val, device)
    init_state, _, epoch = svi.make_train_step(spec, inp.ts, inp.base["lr"], inp.params, dispatch=dispatch)
    eval_epoch = svi.make_eval_epoch(spec, inp.ts, dispatch=dispatch)
    state, mets = init_state(inp.params, inp.base["seed"]), []
    for _ in range(2):
        state, m = epoch(state, stack)
        mets.append(_np_tree(m))
    out = {"params": _np_tree(state.params), "moments": _np_tree([state.opt.mu, state.opt.nu]), "metrics": mets,
           "stats": [_np_tree(eval_epoch(state.params, 7, val, is_post)) for is_post in (True, False)]}
    steps = int(stack["mask"].shape[0])
    out["step_ms"] = _median_ms(lambda: epoch(state, stack), inp.steps, device) / steps
    return out


def _np_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))


def _hold_dp_graphs(name: str, outs, backend: str, paths: dict, rehearse: bool, ref=None) -> dict:
    """:func:`_rank_dp_graphs` on every rank: the replayed way dispatched as
    a CUDA graph and replaying, its launches the eager way's and
    ``backend``'s; the ranks' replayed params, moments, metrics and
    statistics bit for bit each other's; replay against eager bit for bit,
    or else within the data-parallel step's params bound (the ratio is
    returned); with ``ref`` (a group of one), bit for bit the one-device
    epochs."""
    want = "plain" if rehearse else "cuda graph"
    keys = ("params", "moments", "metrics", "stats")
    worst, bit = 0.0, True
    for r, o in enumerate(outs):
        e, g = o["eager"], o["replayed"]
        check(e["dispatch"] == ["eager", "eager"] and g["dispatch"] == [want, want],
              f"{name} rank {r}: dispatch {e['dispatch']}, {g['dispatch']}")
        check(rehearse or g["replays"] == 2 * GRAPH_STEPS + 1,
              f"{name} rank {r}: {g['replays']} CUDA graph replays, not {2 * GRAPH_STEPS + 1}")
        check(e["counts"] == g["counts"], f"{name} rank {r}: launches {g['counts']} replayed, {e['counts']} eager")
        _check_rank_counts(paths, f"ranks {name} rank{r}", g["counts"], TRAINING[backend], rehearse)
        same = all(_np_equal(e[k], g[k]) for k in keys)
        bit = bit and same
        if not same:
            worst = max(worst, max(ratio(torch.as_tensor(x), torch.as_tensor(y), DP_PARAM_ATOL, DP_PARAM_RTOL)
                                   for x, y in zip(tree_leaves([g["params"], g["moments"]]),
                                                   tree_leaves([e["params"], e["moments"]]))))
        if ref is not None:
            check(all(_np_equal(g[k], ref[k]) and _np_equal(e[k], ref[k]) for k in keys),
                  f"{name} rank {r}: differs from the one-device epochs")
    check(all(all(_np_equal(o["replayed"][k], outs[0]["replayed"][k]) for k in keys) for o in outs[1:]),
          f"{name}: the ranks' replayed epochs differ")
    check(worst <= 1.0, f"{name}: replay against eager {worst:.3e} of the params bound")
    print(f"{name}: {len(outs)} rank(s), replayed ({[o['replayed']['replays'] for o in outs]} replays) "
          f"{'bit for bit' if bit else f'within {worst:.3e} of the params bound of'} eager, the ranks bit for bit "
          f"each other, launches equal", flush=True)
    return {"bit_equal": bit, "params_bound_ratio": worst, "replays": [o["replayed"]["replays"] for o in outs],
            "step_ms": [o["step_ms"] for o in outs],
            **({"trace_replayed": [o["trace_replayed"] for o in outs]} if "trace_replayed" in outs[0] else {})}


def _check_rank_dispatch(name: str, outs, reason: str, rehearse: bool) -> None:
    """Each rank's epoch dispatch (``svi.epoch_dispatch`` for its data
    group's reduce) begins with ``reason`` (on the card)."""
    got = [o["dispatch"] for o in outs]
    print(f"{name}: epoch dispatch {got[0]}", flush=True)
    check(rehearse or all(d.startswith(reason) for d in got), f"{name}: epoch dispatch {got}, not {reason!r}")


def _wl_tag(wl: str) -> str:
    """The prefix of a case's name at workload ``wl``: none at CVS, whose
    names are those of PR 9 and 10."""
    return "" if wl == "cvs" else f"{wl} "


def _hold_dp(name: str, outs, inp: RankInputs, backend: str, paths: dict, rehearse: bool) -> list:
    """Each rank's data-parallel step (:func:`_rank_dp_step`) against the
    one-device step, gradients included, the ranks' params bit for bit
    equal, and each rank's launches those of ``backend``."""
    state, mets, _, grads = inp.refs[backend]
    worst = [_hold_step(f"{name} rank {r} ({o['rows']} rows)", o, state, mets, DP_LOSS_RTOL, DP_PARAM_RTOL,
                        DP_PARAM_ATOL, grads) for r, o in enumerate(outs)]
    same = all(all(np.array_equal(x, y) for x, y in zip(tree_leaves(o["params"]), tree_leaves(outs[0]["params"])))
               for o in outs[1:])
    check(same, f"{name}: the ranks' params differ after the step")
    for r, o in enumerate(outs):
        _check_rank_counts(paths, f"ranks {name} rank{r}", o["counts"], TRAINING[backend], rehearse)
    return worst


def _hold_tp(name: str, outs, inp: RankInputs, paths: dict, rehearse: bool) -> dict:
    """Each rank's time-parallel case (:func:`_rank_tp_case`) against one
    device on semilinear: the solve's values, the main loss's gradients, the
    dual step, the recurrence against K1; K1 and K1-bwd launched. Returns
    the worst error over its tolerance of each."""
    state, mets, _, _ = inp.refs["semilinear"]
    worst = collections.defaultdict(float)
    for r, o in enumerate(outs):
        v = ratio(torch.as_tensor(o["solve"]), inp.ref_solve, TP_VALUE_ATOL, TP_VALUE_RTOL)
        g = max(ratio(torch.as_tensor(x), y.cpu(), TP_ATOL, TP_RTOL)
                for x, y in zip(tree_leaves(o["grads"]), tree_leaves(inp.ref_grads)))
        lg = ratio(torch.as_tensor(o["long"]), inp.ref_long, TP_VALUE_ATOL)
        print(f"{name} rank {r}: solve values error / tolerance {v:.3e}, main-loss gradients {g:.3e}, recurrence "
              f"of {inp.long_t} steps against K1 {lg:.3e}", flush=True)
        check(v <= 1.0 and g <= 1.0 and lg <= 1.0, f"{name} rank {r}: the time-parallel solve disagrees")
        step = _hold_step(f"{name} dual step rank {r}", o, state, mets, DP_LOSS_RTOL, TP_RTOL, TP_ATOL)
        for k, x in (("values", v), ("grads", g), ("long", lg), ("step_loss", step["loss"]),
                     ("step_params", step["params"])):
            worst[k] = max(worst[k], x)
        _check_rank_counts(paths, f"ranks {name} semilinear_timepar rank{r}", o["counts"], TRAINING["semilinear"],
                           rehearse)
        _check_rank_counts(paths, f"ranks {name} recurrence T={inp.long_t} rank{r}", o["long_counts"], ("K1",),
                           rehearse)
    return dict(worst)


def _sweep_leaves(r):
    return tree_leaves([r.best_params, r.state.params, r.state.opt.mu, r.state.opt.nu])


def _hold_sweep(name: str, got, grouped, stacked_ref, bit_equal: bool) -> dict:
    """A member-sharded sweep's stacked result against the unsharded sweep
    in member groups of a rank's size (the member-sharded bound: params
    within ENS_RTOL and ENS_ATOL, Adam's moments within ENS_RTOL of each
    leaf's largest, at least 1, the criterion within ENS_CRIT_RTOL; best
    epochs equal; bit for bit where ``bit_equal``) and against the unsharded
    stack of all members (params within the stacked-member bound, the
    criterion within ENS_CRIT_RTOL)."""
    rtol, atol, crit_rtol = ENS_RTOL, ENS_ATOL, ENS_CRIT_RTOL
    n_params = len(tree_leaves([got.best_params, got.state.params]))  # the moments follow
    pairs = [(x, y.cpu()) for x, y in zip(_sweep_leaves(got), _sweep_leaves(grouped))]
    par = max(ratio(x, y, atol, rtol) for x, y in pairs[:n_params])
    moments = max(float((x - y).abs().max()) / (rtol * max(float(y.abs().max()), 1.0)) for x, y in pairs[n_params:])
    equal = all(torch.equal(x, y) for x, y in pairs) and np.array_equal(got.best_crit, grouped.best_crit)
    stacked = max(ratio(x, y.cpu(), STACKED_ATOL, STACKED_RTOL)
                  for x, y in zip(_sweep_leaves(got)[:n_params], _sweep_leaves(stacked_ref)[:n_params]))
    crit = max(float(np.max(np.abs(got.best_crit - r.best_crit) / (crit_rtol * np.abs(r.best_crit))))
               for r in (grouped, stacked_ref))
    epochs = [got.best_epoch.tolist(), grouped.best_epoch.tolist(), stacked_ref.best_epoch.tolist()]
    print(f"{name}, against the unsharded sweep in member groups of a rank's size: params error / tolerance "
          f"{par:.3e}, Adam moments {moments:.3e}, all bit for bit {equal}; params against the unsharded stack of "
          f"all members (stacked-member bound) {stacked:.3e}; criterion {crit:.3e}; best epochs {epochs[0]} "
          f"(grouped {epochs[1]}, unsharded {epochs[2]})", flush=True)
    check(par <= 1.0 and moments <= 1.0 and stacked <= 1.0 and crit <= 1.0 and epochs[0] == epochs[1] == epochs[2],
          f"{name}: the member-sharded sweep differs from the unsharded one")
    check(equal or not bit_equal, f"{name}: not bit for bit the unsharded sweep in member groups of a rank's size")
    return {"params_over_tol": par, "moments_over_tol": moments, "bit_equal": equal,
            "params_over_stacked_tol": stacked}


def phase_ranks(device, workdir: str, data_dir: str, rehearse: bool, smi: str, paths: dict) -> dict:
    """Phase 10 (module comment above): (a) the data-parallel dual step
    through an NCCL group of one rank, bit for bit the one-device step; (b)
    two gloo ranks on the card, half the training batch each (CVS 64 rows,
    proc 18, challenge 16), on semilinear_fused (K2, K3) and semilinear (K1,
    K1-bwd), at CVS, proc and challenge; (c) the horizon over two ranks
    (semilinear_timepar: K1, K1-bwd) at each workload's training batch and
    horizon (85, 99 and 141 steps), and the recurrence at LONG_T steps at its
    ODE state width against K1; (d) a CVS sweep of four members
    over --ensemble-parallel 2 on semilinear_fused against the unsharded
    sweep; (e) the CLI with --data-parallel 2 on one card raises before any
    launch, naming the card count. Launches are counted per rank and case."""
    t_phase = time.perf_counter()
    inputs = {wl: RankInputs(device, data_dir, rehearse, wl) for wl in RANK_WORKLOADS}
    inp = inputs["cvs"]
    B, ref_ms = inp.B, inp.ref_ms
    pool_device = "cpu" if rehearse else "cuda:0"
    base = dict(inp.base, device=pool_device)
    res = {"label": RANKS_LABEL, "one_device_step_ms": {wl: i.ref_ms for wl, i in inputs.items()}}
    t0 = time.perf_counter()
    rank_threads = torch.get_num_threads() if rehearse else RANK_THREADS
    with launch.RankPool(2, device=pool_device, backend="gloo", timeout_s=300, threads=rank_threads,
                         quiet=True) as pool:
        pool.run(_rank_world)
        res["ranks_start_s"] = time.perf_counter() - t0
        print(f"== two ranks up in {res['ranks_start_s']:.1f} s ({RANKS_LABEL}; {smi})", flush=True)

        # (a) NCCL, a group of one rank on cuda:0 (gloo in a rehearsal)
        a = pool.run(_rank_dp_step, dict(base, ranks=[0], group_backend="gloo" if rehearse else "nccl",
                                         backend="semilinear_fused"))[0]
        state, mets, _, grads = inp.refs["semilinear_fused"]
        same = all(np.array_equal(o, r.cpu().numpy()) for o, r in zip(tree_leaves([a["params"], a["grads"]]),
                                                                       tree_leaves([state.params, grads])))
        same = same and a["loss_main"] == float(mets["loss_main"]) and a["loss_aux"] == float(mets["loss_aux"])
        print(f"(a) data-parallel dual step through an NCCL group of one rank, B={B}: bit for bit the one-device "
              f"step (losses, gradients, params): {same}; {a['ms']:.3f} ms a step, one device "
              f"{ref_ms['semilinear_fused']:.3f} ms ({smi})", flush=True)
        check(same, "(a) the NCCL group of one differs from the one-device step")
        _check_rank_counts(paths, "ranks nccl world 1 semilinear_fused", a["counts"], TRAINING["semilinear_fused"],
                           rehearse)
        res["nccl_world1"] = {"bit_equal": same, "ms": a["ms"]}
        check(rehearse or a["dispatch"] == "cuda graph", f"(a) the NCCL group of one dispatches {a['dispatch']}")
        # its training and eval epochs replayed, bit for bit one device's
        outs = pool.run(_rank_dp_graphs, dict(base, ranks=[0], group_backend="gloo" if rehearse else "nccl",
                                              backend="semilinear_fused", stack=inp.stack, val=inp.val,
                                              graphed="plain" if rehearse else None))[:1]
        one = _one_device_epochs(inp, "semilinear_fused")
        res["nccl_world1"]["graphs"] = _hold_dp_graphs(
            f"(a) two epochs of {GRAPH_STEPS} steps and the eval epochs through an NCCL group of one, bit for bit one "
            "device", outs, "semilinear_fused", paths, rehearse, ref=one)

        # (b) two gloo ranks on the card, half the batch each, at each workload
        for wl, w_inp in inputs.items():
            tag = _wl_tag(wl)
            for backend in ("semilinear_fused", "semilinear"):
                outs = pool.run(_rank_dp_step, dict(w_inp.base, device=pool_device, ranks=[0, 1],
                                                    group_backend="gloo", backend=backend))
                worst = _hold_dp(f"(b) {tag}dp2 gloo {backend}", outs, w_inp, backend, paths, rehearse)
                _check_rank_dispatch(f"(b) {tag}dp2 gloo {backend}", outs, "eager (ranks over gloo: ", rehearse)
                print(f"(b) {tag}data-parallel 2 {backend} B={w_inp.B}: ranks' params bit for bit equal; median of "
                      f"{w_inp.steps} steps {[round(o['ms'], 3) for o in outs]} ms a rank, one device "
                      f"{w_inp.ref_ms[backend]:.3f} ms ({RANKS_LABEL}; {smi})", flush=True)
                res[f"{tag.replace(' ', '_')}dp2_{backend}"] = {"ms": [o["ms"] for o in outs], "worst": worst}

        # (c) the horizon over two ranks, at each workload
        for wl, w_inp in inputs.items():
            tag = _wl_tag(wl)
            outs = pool.run(_rank_tp_case, w_inp.tp_case(pool_device, (1, 2)))
            worst = _hold_tp(f"(c) {tag}tp2 gloo", outs, w_inp, paths, rehearse)
            _check_rank_dispatch(f"(c) {tag}tp2 gloo", outs, "eager (ranks over gloo: ", rehearse)
            print(f"(c) {tag}time-parallel 2 B={w_inp.B}, {w_inp.ts.numel() - 1} steps: median of {w_inp.steps} dual "
                  f"steps {[round(o['ms'], 3) for o in outs]} ms a rank (one device on semilinear "
                  f"{w_inp.ref_ms['semilinear']:.3f} ms); recurrence of {w_inp.long_t} steps "
                  f"{outs[0]['long_ms']:.3f} ms, first call ({RANKS_LABEL}; {smi})", flush=True)
            res[f"{tag.replace(' ', '_')}tp2"] = {"ms": [o["ms"] for o in outs],
                                                  "long_ms": [o["long_ms"] for o in outs], "worst": worst}

        # (d) a sweep of four members over two member ranks, held bit for bit
        # to the unsharded sweep in member groups of two at this process's
        # thread count (the ranks run at RANK_THREADS)
        seeds = "12,13" if rehearse else "12..15"
        argv = ["cvs", "--seeds", seeds, "--num-epochs", "1", "--ode-backend", "semilinear_fused", "--data-path",
                data_dir, "--device", pool_device]
        t0 = time.perf_counter()
        ref = sweep.run(sweep.parse_args(argv + ["--results-root", os.path.join(workdir, "ranks-sweep-1")]))
        t_one = time.perf_counter() - t0
        grouped = sweep.run(sweep.parse_args(argv + ["--results-root", os.path.join(workdir, "ranks-sweep-g"),
                                                     "--member-group", str(len(sweep.parse_seeds(seeds)) // 2)]))
        t0 = time.perf_counter()
        outs = pool.run(_rank_sweep, argv + ["--results-root", os.path.join(workdir, "ranks-sweep-2"),
                                             "--ensemble-parallel", "2"])
        t_two = time.perf_counter() - t0
        held = _hold_sweep(f"(d) sweep of {len(sweep.parse_seeds(seeds))} members over --ensemble-parallel 2",
                           outs[0]["result"], grouped.result, ref.result, bit_equal=True)
        print(f"(d) {t_two:.2f} s wall on the ranks, {t_one:.2f} s unsharded ({RANKS_LABEL}; {smi})", flush=True)
        check([m["seed"] for m in outs[0]["summary"]["members"]] == sweep.parse_seeds(seeds), "(d) sweep.json seeds")
        for r, o in enumerate(outs):  # rank 0 alone finalizes: the test evals' single-member K2
            _check_rank_counts(paths, f"ranks sweep ens2 semilinear_fused rank{r}", o["counts"],
                               SWEEP["semilinear_fused"] if r == 0 else STACKED["semilinear_fused"], rehearse)
            check(rehearse or o["replays"] > 0, f"(d) rank {r} replayed no CUDA graph")
        res["sweep_ens2"] = {"wall_s": t_two, "unsharded_wall_s": t_one, "replays": [o["replays"] for o in outs],
                             **held}

    # (e) the CLI past the cards: raises before any launch, naming them
    zero_counts()
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    try:
        training_cvs.main(["--num-epochs", "1", "--no-plot", "--data-parallel", str(n_cards + 1), "--data-path",
                           data_dir, "--results-root", os.path.join(workdir, "ranks-cli"),
                           "--device", "cuda" if device.type == "cuda" else "cpu"] +
                          (["--mini-batch-size", str(8 * (n_cards + 1))] if rehearse else []))
        raised = None
    except ValueError as e:
        raised = str(e)
    counts = read_counts()
    print(f"(e) training_cvs --data-parallel {n_cards + 1} on {n_cards} card(s): {raised!r}; launches {counts}",
          flush=True)
    if not rehearse:
        check(raised is not None and f"> {n_cards} available devices" in raised and not any(counts.values()),
              "(e) the CLI past the cards must raise before any launch, naming the card count")
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"== phase 10 took {res['wall_s']:.1f} s ({smi})", flush=True)
    return res


# Phase 11: the layouts across cards over NCCL (ROADMAP C4; C6 at proc and
# challenge), one card a rank,
# where the machine has CARDS cards or more: four ranks spawned once
# (RankPool(4, device="cuda", backend="nccl"): rank r on cuda:r) run every
# case; the parent computes the one-device references on cuda:0, under
# phase 10's bounds. A sweep sharded over members and minibatches (each
# minibatch's sums also cross the data ranks, in another order) is held to
# phase 10's member-sharded bound against the unsharded sweep in member
# groups of a rank's size, short of bit for bit. The CLIs run as users start
# them, the training CLI spawning its ranks and under torchrun: both on the
# same four cards, so their artifacts are held bit for bit to each other;
# against the one-device run, best_model.npz and the .npy outputs elementwise
# within the data-parallel step's params bound. Launches in processes the
# CLIs start are read at their exit (_CountHook).
CARDS = 4
CARDS_LABEL = "four cards of one host, one a rank, over NCCL"
TRAINING_CLI, SWEEP_CLI = "structured_latent_odes_tpu_torch.training_{}", "structured_latent_odes_tpu_torch.sweep"

# Written as sitecustomize.py into a directory put first on PYTHONPATH of a
# CLI's processes: at its exit each process that launched a kernel writes
# its launch counts and rank (RANK, LOCAL_RANK, or 0 for a run on one card)
# to SLODE_COUNTS_DIR; then the sitecustomize this one shadows, if any, runs
# as it would have.
_COUNT_HOOK = '''
import atexit, importlib.machinery, importlib.util, json, os, sys

def _dump():
    mods = [sys.modules.get("structured_latent_odes_tpu_torch.ops." + m)
            for m in ("recurrence", "fused_step", "conv_encoder")]
    if None in mods:
        return
    rec, fs, ce = mods
    wrappers = {"K1": rec.affine_scan_fwd, "K1-bwd": rec.affine_scan_bwd, "K2": fs.fused_semilinear_fwd,
                "K3": fs.fused_semilinear_bwd, "K2-members": fs.fused_semilinear_fwd_members,
                "K3-members": fs.fused_semilinear_bwd_members,
                **{k: getattr(ce, k) for k in ("conv_pool_fwd", "conv_pool_wgrad", "conv_pool_fwd_members",
                                               "conv_pool_wgrad_members")}}
    counts = {k: w.launches for k, w in wrappers.items()}
    if not any(counts.values()):  # the parent of spawned ranks
        return
    rank = int(os.environ.get("RANK", os.environ.get("LOCAL_RANK", 0)))
    with open(os.path.join(os.environ["SLODE_COUNTS_DIR"], "rank%d-%d.json" % (rank, os.getpid())), "w") as f:
        json.dump({"rank": rank, "counts": counts}, f)

atexit.register(_dump)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''


class _CountHook:
    """The environment under which a CLI's processes report their launches
    at exit (``_COUNT_HOOK``); ``counts()`` reads them by rank."""

    def __init__(self, workdir: str, name: str):
        hook_dir = os.path.join(workdir, f"count-hook-{name}")
        self.out = os.path.join(hook_dir, "counts")
        os.makedirs(self.out)
        with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
            f.write(_COUNT_HOOK)
        self.env = {"PYTHONPATH": os.pathsep.join([hook_dir, REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
                    "SLODE_COUNTS_DIR": self.out}

    def counts(self) -> dict:
        out = {}
        for name in sorted(os.listdir(self.out)):
            with open(os.path.join(self.out, name)) as f:
                rec = json.load(f)
            check(rec["rank"] not in out, f"two processes reported rank {rec['rank']}'s launches")
            out[rec["rank"]] = rec["counts"]
        return out


def _same_sweep(got, ref) -> bool:
    """Whether two stacked sweep results are bit for bit equal."""
    return (all(torch.equal(x, y) for x, y in zip(_sweep_leaves(got), _sweep_leaves(ref)))
            and np.array_equal(got.best_crit, ref.best_crit) and np.array_equal(got.best_epoch, ref.best_epoch))


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _arrays(path: str) -> dict:
    """The arrays of a results file: an .npy, or each array of an .npz."""
    if path.endswith(".npy"):
        return {"": np.load(path)}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _hold_artifacts(name: str, got_dir: str, ref_dir: str, rtol: float = 0.0, atol: float = 0.0):
    """Every .npy and .npz of ``got_dir`` against ``ref_dir``'s (the same
    files): bit for bit where ``rtol`` and ``atol`` are 0; else each float
    within ``atol + rtol*|ref|``. Returns the worst error over its tolerance
    and the file (and array) where it is."""
    got_files = [f for f in _files(got_dir) if f.endswith((".npy", ".npz"))]
    check(got_files == [f for f in _files(ref_dir) if f.endswith((".npy", ".npz"))],
          f"{name}: the artifacts differ from the reference's: {got_files}")
    worst, where = 0.0, None
    for f in got_files:
        got, ref = _arrays(os.path.join(got_dir, f)), _arrays(os.path.join(ref_dir, f))
        check(sorted(got) == sorted(ref), f"{name} {f}: the arrays differ")
        for k in ref:
            a, b = got[k], ref[k]
            if not (rtol or atol) or b.dtype.kind != "f":
                check(a.dtype == b.dtype and np.array_equal(a, b), f"{name} {f} {k}: not bit for bit")
                continue
            err = float(np.max(np.abs(a.astype(np.float64) - b) / (atol + rtol * np.abs(b))))
            if err > worst:
                worst, where = err, f"{f} {k}".strip()
    check(worst <= 1.0, f"{name}: error / tolerance {worst:.3e} at {where}")
    return worst, where


def _check_cli_counts(paths: dict, name: str, hook: _CountHook, n: int, expected_of, rehearse: bool) -> dict:
    """Each of the ``n`` ranks of a CLI's run launched ``expected_of(rank)``'s
    kernels and no other (read at the processes' exit)."""
    counts = hook.counts()
    check(rehearse or sorted(counts) == list(range(n)), f"{name}: launch counts from ranks {sorted(counts)}")
    for r, c in counts.items():
        _check_rank_counts(paths, f"cards {name} rank{r}", c, expected_of(r), rehearse)
    return counts


def phase_cards(device, workdir: str, data_dir: str, rehearse: bool, smi: str, paths: dict) -> dict:
    """Phase 11 (module comment above), on CARDS cards, one a rank: (a) the
    data-parallel dual step over the four cards (CVS 32 rows a rank, proc 9,
    challenge 8) and, at CVS, over two of them, on semilinear_fused (K2, K3)
    and semilinear (K1, K1-bwd); (b) the horizon over data 2 x time 2 and
    over time 4 ranks (semilinear_timepar: K1, K1-bwd) at each workload, and
    the recurrence of LONG_T steps over the time ranks; (c) a CVS sweep of
    eight members and a proc sweep of four over --ensemble-parallel 4 (bit
    for bit the unsharded sweep in member groups of a rank's size) and over
    --ensemble-parallel 2 --ensemble-data-parallel 2 on semilinear_fused,
    each rank writing under its own root (rank 0 alone must write); (d)
    training_cvs, training_proc and training_challenge --data-parallel 4
    spawned by the CLI and under torchrun, bit for bit each other and within
    (a)'s bounds of the one-device run, and the sweep CLI over
    --ensemble-parallel 4, bit for bit (c)'s CVS sweep; (e) --data-parallel
    5 raises before any launch. Where the
    machine has fewer cards it prints so and returns None; a rehearsal runs
    four gloo ranks on the CPU."""
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if not rehearse and n_cards < CARDS:
        print(f"== phase 11 needs {CARDS} cards and found {n_cards}: not run", flush=True)
        return None
    t_phase = time.perf_counter()
    inputs = {wl: RankInputs(device, data_dir, rehearse, wl) for wl in RANK_WORKLOADS}
    pool_device = "cpu" if rehearse else "cuda"
    label = "rehearsal: four gloo ranks on the CPU" if rehearse else CARDS_LABEL
    res = {"label": label, "one_device_step_ms": {wl: i.ref_ms for wl, i in inputs.items()}}
    # a limit on the host's load (no result depends on the host's threads on
    # the card); on the CPU the ranks compute at this process's count, as
    # its references do
    threads = torch.get_num_threads() if rehearse else max(1, len(os.sched_getaffinity(0)) // CARDS)
    t0 = time.perf_counter()
    with launch.RankPool(CARDS, device=pool_device, timeout_s=300, threads=threads, quiet=True) as pool:
        cards = pool.run(_rank_card)
        res["ranks_start_s"] = time.perf_counter() - t0
        print(f"== {CARDS} ranks up in {res['ranks_start_s']:.1f} s, {threads} intra-op threads each: {cards} "
              f"({label}; {smi})", flush=True)
        check(rehearse or [c.split()[0] for c in cards] == [f"cuda:{r}" for r in range(CARDS)],
              f"the ranks' cards: {cards}")

        # (a) data parallelism over four cards at each workload, and over two
        # at CVS
        for wl, inp in inputs.items():
            tag = _wl_tag(wl)
            for backend in ("semilinear_fused", "semilinear"):
                rec = res[f"{tag.replace(' ', '_')}dp_{backend}"] = {"one_card_ms": inp.ref_ms[backend]}
                for n in (CARDS, 2) if wl == "cvs" else (CARDS,):
                    outs = pool.run(_rank_dp_step, dict(inp.base, device=pool_device, ranks=list(range(n)),
                                                        group_backend=None, backend=backend, time_reduce=True))
                    check(all(o is None for o in outs[n:]), "(a) a rank outside the grid returned a step")
                    outs = outs[:n]
                    worst = _hold_dp(f"(a) {tag}dp{n} {backend}", outs, inp, backend, paths, rehearse)
                    _check_rank_dispatch(f"(a) {tag}dp{n} {backend}", outs, "plain" if rehearse else "cuda graph", rehearse)
                    print(f"(a) {tag}data-parallel {n} {backend} B={inp.B}: {inp.B // n} rows a rank, ranks' params "
                          f"bit for bit equal; median of {inp.steps} steps {[round(o['ms'], 3) for o in outs]} ms a "
                          f"rank, of which the gradient sums {[round(o['reduce_ms'], 3) for o in outs]} ms (timed "
                          f"apart, between synchronises); one card {inp.ref_ms[backend]:.3f} ms ({label}; {smi})",
                          flush=True)
                    rec[f"cards_{n}"] = {"ms": [o["ms"] for o in outs], "reduce_ms": [o["reduce_ms"] for o in outs],
                                         "worst": worst}

        # (a') the data-parallel training and eval epochs replayed as CUDA
        # graphs over four cards and over two, at CVS, against eager and
        # beside one card's replayed epochs; one replayed epoch traced
        inp = inputs["cvs"]
        for backend in ("semilinear_fused", "semilinear"):
            one = _one_device_epochs(inp, backend, "plain" if rehearse else None)
            rec = res[f"dp_graphs_{backend}"] = {"one_card_replayed_step_ms": one["step_ms"]}
            for n in (CARDS, 2):
                outs = pool.run(_rank_dp_graphs, dict(inp.base, device=pool_device, ranks=list(range(n)),
                                                      group_backend=None, backend=backend, stack=inp.stack,
                                                      val=inp.val, graphed="plain" if rehearse else None,
                                                      trace=not rehearse))[:n]
                held = rec[f"cards_{n}"] = _hold_dp_graphs(f"(a') dp{n} {backend} replayed", outs, backend, paths,
                                                           rehearse)
                nccl = [t["nccl_kernels_ms"] for t in held.get("trace_replayed", [])]
                print(f"(a') data-parallel {n} {backend} B={inp.B}: a replayed dual step "
                      f"{[round(t['replayed'], 3) for t in held['step_ms']]} ms a rank, eager "
                      f"{[round(t['eager'], 3) for t in held['step_ms']]} ms; one card replayed {one['step_ms']:.3f} "
                      f"ms; the NCCL kernels' device time {nccl} ms a step (one trace) ({label}; {smi})", flush=True)

        # (b) the horizon over data 2 x time 2 and over time 4, at each
        # workload
        for wl, inp in inputs.items():
            tag = _wl_tag(wl)
            for grid in ((2, 2), (1, CARDS)):
                name = f"(b) {tag}dp{grid[0]} tp{grid[1]}"
                outs = pool.run(_rank_tp_case, inp.tp_case(pool_device, grid))
                worst = _hold_tp(name, outs, inp, paths, rehearse)
                _check_rank_dispatch(name, outs, "eager (semilinear_timepar: ", rehearse)
                print(f"{name} B={inp.B}, {inp.ts.numel() - 1} steps: median of {inp.steps} dual steps "
                      f"{[round(o['ms'], 3) for o in outs]} ms a rank (one card on semilinear "
                      f"{inp.ref_ms['semilinear']:.3f} ms); recurrence of {inp.long_t} steps over {grid[1]} time "
                      f"ranks {[round(o['long_ms'], 3) for o in outs]} ms, first call ({label}; {smi})", flush=True)
                res[f"{tag.replace(' ', '_')}dp{grid[0]}_tp{grid[1]}"] = {
                    "ms": [o["ms"] for o in outs], "long_ms": [o["long_ms"] for o in outs], "worst": worst}

        # (c) sweeps over the cards: CVS's eight members, each run twice (the
        # second bit for bit the first and timed warm: the first call of a
        # process also loads the member-batched kernels and cuDNN's plans),
        # and proc's four, once (on datasets/proc, the config's 200 draws;
        # the fold pinned, as in phase 7, so that the members deploy)
        sweeps = {"cvs": ("12..15" if rehearse else "12..19", ["--data-path", data_dir], 2),
                  "proc": ("12..15", ["--data-seed", "12"] + (["--num-samples", "2"] if rehearse else []), 1)}
        for wl, (seeds, extra, n_runs) in sweeps.items():
            tag = _wl_tag(wl)
            n_members = len(sweep.parse_seeds(seeds))
            argv = [wl, "--seeds", seeds, "--num-epochs", "1", "--ode-backend", "semilinear_fused"] + extra
            one_argv = argv + ["--device", str(device)]
            stack = [sweep.run(sweep.parse_args(one_argv + [
                "--results-root", os.path.join(workdir, f"cards-sweep-{wl}-1-{i}")])) for i in range(n_runs)]
            check(_same_sweep(stack[-1].result, stack[0].result), f"(c) {tag}the one-card sweep's rerun differs")
            grouped = {g: sweep.run(sweep.parse_args(one_argv + [
                "--results-root", os.path.join(workdir, f"cards-sweep-{wl}-g{g}"), "--member-group", str(g)])).result
                for g in (n_members // CARDS, n_members // 2)}
            res[f"{tag.replace(' ', '_')}sweep_one_card"] = [
                {k: r.summary[k] for k in ("wall_seconds", "train_seconds")} for r in stack]
            print(f"(c) {tag}sweep of {n_members} members on one card{', first and warm' if n_runs > 1 else ''}: "
                  f"{[round(r.summary['wall_seconds'], 3) for r in stack]} s wall, "
                  f"{[round(r.summary['train_seconds'], 3) for r in stack]} s training ({smi})", flush=True)
            for ens, n_data in ((CARDS, 1), (2, 2)):
                name = f"(c) {tag}sweep ens{ens} data{n_data}"
                runs = []
                for i in range(n_runs):
                    root = os.path.join(workdir, f"cards-sweep-{wl}-ens{ens}-data{n_data}-{i}")
                    outs = pool.run(_rank_sweep, argv + ["--device", pool_device, "--results-root", root,
                                                         "--ensemble-parallel", str(ens), "--ensemble-data-parallel",
                                                         str(n_data)], True)
                    written = {r: _files(os.path.join(root, f"rank{r}")) for r in range(CARDS)}
                    check("sweep.json" in written[0] and any(f.startswith("deploy_mean") for f in written[0]),
                          f"{name}: rank 0 wrote no sweep.json or deploy_mean/")
                    check(not any(written[r] for r in range(1, CARDS)), f"{name}: ranks other than 0 wrote files")
                    for r, o in enumerate(outs):
                        _check_rank_counts(paths, f"cards {name} run {i} rank{r}", o["counts"],
                                           SWEEP["semilinear_fused"] if r == 0 else STACKED["semilinear_fused"],
                                           rehearse)
                        # every rank replays: the member ranks on their cards, the data ranks' sums
                        # over NCCL inside the graphs
                        check(rehearse or o["replays"] > 0, f"{name} rank {r}: {o['replays']} CUDA graph replays")
                    runs.append(outs)
                held = _hold_sweep(f"{name}: {n_members} members", runs[0][0]["result"], grouped[n_members // ens],
                                   stack[0].result, bit_equal=n_data == 1)
                check(_same_sweep(runs[-1][0]["result"], runs[0][0]["result"]), f"{name}: the rerun differs")
                summaries = [outs[0]["summary"] for outs in runs]
                check([m["seed"] for m in summaries[0]["members"]] == sweep.parse_seeds(seeds),
                      f"{name}: sweep.json seeds")
                gather = [[o["gather_s"] for o in outs] for outs in runs]
                print(f"{name}{', first and warm' if n_runs > 1 else ''}: "
                      f"{[round(s['wall_seconds'], 3) for s in summaries]} s wall, "
                      f"{[round(s['train_seconds'], 3) for s in summaries]} s training; gather_object "
                      f"{[[round(s, 4) for s in g] for g in gather]} s a rank, {[o['gather_bytes'] for o in runs[-1]]} "
                      f"bytes pickled a rank; rank 0 alone wrote its {len(written[0])} files ({label}; {smi})",
                      flush=True)
                res[f"{tag.replace(' ', '_')}sweep_ens{ens}_data{n_data}"] = {
                    "replays": [o["replays"] for o in runs[0]], "wall_seconds": [s["wall_seconds"] for s in summaries],
                    "train_seconds": [s["train_seconds"] for s in summaries], "gather_s": gather,
                    "gather_bytes": [o["gather_bytes"] for o in runs[-1]], **held}
            if wl == "cvs":
                cvs_sweep = (argv, seeds, os.path.join(workdir, f"cards-sweep-cvs-ens{CARDS}-data1-0", "rank0"))
    # (d) the CLIs end to end, each a process of its own as users start them
    # (their wall times include the processes' start); torchrun starts its
    # ranks at one intra-op thread, the spawned ones take their parent's
    # count: on the card no result depends on it, on the CPU the ranks' own
    # products do, so a rehearsal gives torchrun's ranks the spawned ones'
    one_card = ["--device", "cpu" if rehearse else str(device)]
    dp = ["--data-parallel", str(CARDS)]
    torchrun = ["torch.distributed.run", "--standalone", "--nproc_per_node", str(CARDS), "-m"]
    omp = {"OMP_NUM_THREADS": str(torch.get_num_threads())} if rehearse else {}
    cli = {"cvs": ["--num-epochs", "1", "--no-plot", "--data-path", data_dir] + (
        ["--device", "cpu", "--mini-batch-size", str(2 * CARDS)] if rehearse else [])}
    for wl in WORKLOADS:  # on datasets/, at the config's batch and 200 draws
        cli[wl] = ["--num-epochs", "1", "--no-plot"] + (["--device", "cpu", "--num-samples", "2"] if rehearse else [])
    runs = {}  # name: (python -m argv, ranks, the kernels rank r launches)
    for wl, args in cli.items():
        module = TRAINING_CLI.format(wl)
        runs.update({
            f"training_{wl} one card": ([module] + args + one_card, 1, lambda r: TRAINING["semilinear"]),
            f"training_{wl} spawned": ([module] + args + dp, CARDS, lambda r: TRAINING["semilinear"]),
            f"training_{wl} torchrun": (torchrun + [module] + args + dp, CARDS, lambda r: TRAINING["semilinear"]),
        })
    argv, seeds, ens_root = cvs_sweep
    runs.update({
        "sweep one card": ([SWEEP_CLI] + argv + one_card, 1, lambda r: SWEEP["semilinear_fused"]),
        "sweep spawned": ([SWEEP_CLI] + argv + ["--device", pool_device, "--ensemble-parallel", str(CARDS)], CARDS,
                          lambda r: SWEEP["semilinear_fused"] if r == 0 else STACKED["semilinear_fused"]),
    })
    roots, res["cli_s"], res["cli_vs_one_card"] = {}, {}, {}
    for name, (args, n, expected) in runs.items():
        roots[name] = os.path.join(workdir, "cards-cli-" + name.replace(" ", "-"))
        hook = _CountHook(workdir, name.replace(" ", "-"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m"] + args + ["--results-root", roots[name]], cwd=REPO,
                              env={**os.environ, **hook.env, **omp}, capture_output=True, text=True, timeout=600)
        res["cli_s"][name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"(d) {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        _check_cli_counts(paths, name, hook, n, expected, rehearse)
    model_dir = f"results_{load_cvs_config().model}"
    for wl in cli:
        out_dir = {k: os.path.join(roots[f"training_{wl} {k}"], model_dir) for k in ("one card", "spawned", "torchrun")}
        for k in ("spawned", "torchrun"):
            check(_files(roots[f"training_{wl} {k}"]) == _files(roots[f"training_{wl} one card"]),
                  f"(d) training_{wl} {k}: its files are not the one-card run's")
            with open(os.path.join(out_dir[k], "model.log")) as f:
                check(sum("loss=" in line for line in f) == 2,
                      f"(d) training_{wl} {k}: model.log holds other than rank 0's two epochs")
        _hold_artifacts(f"(d) training_{wl} torchrun against spawned", out_dir["torchrun"], out_dir["spawned"])
        worst, where = _hold_artifacts(f"(d) training_{wl} spawned against one card", out_dir["spawned"],
                                       out_dir["one card"], DP_PARAM_RTOL, DP_PARAM_ATOL)
        res["cli_vs_one_card"][wl] = {"worst": worst, "where": where}
        print(f"(d) training_{wl} --data-parallel {CARDS} spawned and under torchrun bit for bit each other, their "
              f"artifacts elementwise within (a)'s params bound of one card ({worst:.3e}, worst at {where}), the same "
              f"files as the one-card run ({label}; {smi})", flush=True)
    for seed in sweep.parse_seeds(seeds):
        _hold_artifacts(f"(d) sweep seed {seed} against (c)", os.path.join(roots["sweep spawned"], f"seed{seed}"),
                        os.path.join(ens_root, f"seed{seed}"))
    print(f"(d) the CLIs' wall times, process start included: "
          f"{ {k: round(v, 3) for k, v in res['cli_s'].items()} } s; the sweep over --ensemble-parallel {CARDS} bit "
          f"for bit (c)'s ({label}; {smi})", flush=True)

    # (e) past the cards: raises before any launch, naming them
    zero_counts()
    count = torch.cuda.device_count
    if rehearse:  # the CPU takes the ranks asked for: pretend to have the cards
        torch.cuda.device_count = lambda: CARDS
    try:
        training_cvs.main(cli["cvs"] + ["--results-root", os.path.join(workdir, "cards-past"), "--data-parallel",
                                        str(CARDS + 1), "--device", "cuda"])
        raised = None
    except ValueError as e:
        raised = str(e)
    finally:
        torch.cuda.device_count = count
    counts = read_counts()
    print(f"(e) training_cvs --data-parallel {CARDS + 1} on {CARDS} cards: {raised!r}; launches {counts}", flush=True)
    check(raised is not None and f"> {CARDS} available devices" in raised and not any(counts.values()),
          "(e) the CLI past the cards must raise before any launch, naming the card count")
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"== phase 11 took {res['wall_s']:.1f} s ({label}; {smi})", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rehearse", action="store_true", help="CPU dry run with the plain versions")
    p.add_argument("--cards", action="store_true",
                   help=f"phases 1, 2 and 11 only: the layouts across {CARDS} cards over NCCL")
    args = p.parse_args(argv)

    device, smi = phase_device(args.rehearse)
    CARD["smi"] = smi
    full_fp32()
    cfg = load_cvs_config()
    H, D = cfg.ode_hidden_dim, cfg.ode_state_dim
    wl_cfgs = {wl: LOADERS[wl]() for wl in WORKLOADS}
    if not args.rehearse:
        phase("2: build")
        phase_build(sorted({(H, D)} | {(c.ode_hidden_dim, c.ode_state_dim) for c in wl_cfgs.values()} | set(WIDE)))
    if args.cards:
        return main_cards(device, args.rehearse, smi)
    clock = Clock(device)
    odes = {"cvs": init_params(cvs_spec(cfg), 0, device=device)["decoder"]["ode"]}
    for wl, w in WORKLOADS.items():
        odes[wl] = init_params(w["spec"](wl_cfgs[wl], n_time=w["T"]), 0, device=device)["decoder"]["ode"]
    phase("3: kernels against their plain versions")
    res = phase_kernels(device, clock, args.rehearse, odes, H, D)
    paths = {}  # path name -> launch counts of that path's run
    phase("3: C1, K1 and K1-bwd past their shared-memory cap")
    phase_long_horizon(device, clock, args.rehearse, smi, res, paths)
    phase("3: member-batched K2 and K3")
    phase_members(device, clock, args.rehearse, smi, res)
    phase("3: the conv encoder's kernels")
    phase_conv(device, clock, args.rehearse, smi, res)
    phase("3: C2, K2 and K3 at dopri5 and at wide widths")
    c2 = phase_c2(device, clock, args.rehearse, smi, odes)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    try:
        phase("4: serving CVS")
        ckpts, data_dir = phase_serving(device, workdir, args.rehearse, paths)
        phase_request_times(device, clock, ckpts, data_dir, args.rehearse, smi)
        phase("5: training CVS")
        phase_training(device, workdir, data_dir, args.rehearse, paths)
        phase_train_checks(device, clock, data_dir, args.rehearse, smi, paths)
        phase("6: proc and challenge")
        phase_workloads(device, clock, workdir, args.rehearse, smi, paths)
        phase("7: the stacked dual step")
        phase_stacked_step(device, clock, data_dir, args.rehearse, smi)
        phase("7: sweeps")
        phase_sweeps(device, workdir, data_dir, args.rehearse, smi, paths)
        phase("8: the paths through C2's kernels")
        phase_c2_paths(device, data_dir, args.rehearse, smi, paths)
        phase("8: the ODE backend menu")
        phase_menu(device, clock, data_dir, args.rehearse, smi, paths)
        phase("8: the menu's training epochs as CUDA graphs")
        menu_graphs = phase_graph_menu(device, data_dir, args.rehearse, paths)
        phase("8: sweeps on adjoint and adaptive")
        phase_menu_sweeps(device, workdir, args.rehearse, smi, paths)
        t9 = time.perf_counter()
        phase("9: batch-exact resume")
        phase_resume(device, workdir, data_dir, args.rehearse, paths)
        phase("9: the profiler trace")
        phase_trace(device, workdir, data_dir, args.rehearse, paths)
        phase("9: the native host library")
        phase_native(args.rehearse, smi)
        phase("9: the reference's CVS pickles")
        phase_pickles(device, workdir, data_dir, args.rehearse, paths)
        phase("9: the samplers")
        phase_samplers(device, args.rehearse)
        phase("9: plotting")
        phase_plot_check(device, workdir, data_dir, args.rehearse, paths)
        print(f"== phase 9 took {time.perf_counter() - t9:.1f} s ({smi})", flush=True)
        phase("10: data, time and member parallelism over ranks")
        ranks = phase_ranks(device, workdir, data_dir, args.rehearse, smi, paths)
        phase(f"11: the layouts across {CARDS} cards over NCCL")
        cards = phase_cards(device, workdir, data_dir, args.rehearse, smi, paths)
        t12 = time.perf_counter()
        phase("12: the training and eval epochs as CUDA graphs")
        graphed = phase_graphs(device, data_dir, args.rehearse, smi, paths)
        graphed["menu"] = menu_graphs
        print(f"== phase 12 took {time.perf_counter() - t12:.1f} s ({smi})", flush=True)
        t13 = time.perf_counter()
        phase("13: the sweeps' epochs as CUDA graphs")
        graphed["sweeps"] = phase_sweep_graphs(device, data_dir, args.rehearse, smi, paths)
        print(f"== phase 13 took {time.perf_counter() - t13:.1f} s ({smi})", flush=True)
        phase("14: the predict and eval functions as CUDA graphs")
        graphed["served"] = phase_served_graphs(device, workdir, data_dir, ckpts, args.rehearse, smi, paths)
        phase("done")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # times at the training shapes (B = 128, the training path; the member-
    # batched launches at the CVS sweep's S = 10, B = 128); the serving,
    # large, long-horizon (C1) and proc and challenge shapes beside them.
    # "launches" is the count of the kernel's main path, the CVS full-width
    # training run on its backend (the CVS sweep on semilinear_fused for the
    # member-batched launches); every path's count stands beside it.
    kernels = []
    for key, name, source, replaces, main_path, label in (
        ("K1", "affine_scan_fwd", K1_SOURCE, K1_REPLACES, "train semilinear", "train"),
        ("K1-bwd", "affine_scan_bwd", K1_SOURCE, K1_BWD_REPLACES, "train semilinear", "train"),
        ("K2", "fused_semilinear_fwd", K2_SOURCE, K2_REPLACES, "train semilinear_fused", "train"),
        ("K3", "fused_semilinear_bwd", K3_SOURCE, K3_REPLACES, "train semilinear_fused", "train"),
        ("K2-members", "fused_semilinear_fwd_members", K2_SOURCE, K2_REPLACES, "sweep cvs semilinear_fused", "cvs"),
        ("K3-members", "fused_semilinear_bwd_members", K3_SOURCE, K3_REPLACES, "sweep cvs semilinear_fused", "cvs"),
    ):
        t = res[key][label]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[main_path][key], "main_path": main_path,
            "launches_by_path": {path: counts[key] for path, counts in paths.items()},
            "max_abs_err": res[key]["err"],
            "tolerance": {out: {"rule": rule, "worst_error_over_tolerance": res[key]["worst"][out]}
                          for out, rule in TOLERANCE_RULES[key].items()},
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
            **{other: res[key][other] for other in ("serve", "big", "affine_scan_call", "proc_train",
                                                     "challenge_train", "c1_D5", "c1_D8", "proc")
               if other in res[key]},
        })
    # the conv encoder's kernels: one model's at CVS's training batch (main
    # path: CVS training on semilinear_fused), the member-batched at the proc
    # sweep's ten members (main path: the proc sweep); their other shapes
    # beside them, and cuDNN's way of the same work as library_ms
    for key, main_path, label in (("conv_pool_fwd", "train semilinear_fused", "cvs"),
                                  ("conv_pool_wgrad", "train semilinear_fused", "cvs"),
                                  ("conv_pool_fwd_members", "sweep proc semilinear_fused", "proc_S10"),
                                  ("conv_pool_wgrad_members", "sweep proc semilinear_fused", "proc_S10")):
        t = res[key][label]
        kernels.append({
            "name": key, "route": "cuda", "source": CONV_SOURCE, "replaces": CONV_REPLACES,
            "launches": paths[main_path][key], "main_path": main_path,
            "launches_by_path": {path: counts.get(key) for path, counts in paths.items()},
            "max_abs_err": res[key]["err"],
            "tolerance": {out: {"rule": rule, "worst_error_over_tolerance": res[key]["worst"][out]}
                          for out, rule in TOLERANCE_RULES[key].items()},
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            **{other: res[key][other] for other in CONV_SHAPES if other != label and other in res[key]},
        })
    # C2's kernels: K2 and K3 at dopri5 and at the wide widths, each with
    # the launches of its variant (method, H, D) on the path that runs it
    c2_paths = {"dopri5 cvs": "c2 cvs dopri5 semilinear_auto", "dopri5 proc": "c2 proc dopri5 semilinear_auto",
                "dopri5 proc members": "c2 proc stacked S=5 dopri5 semilinear_fused",
                **{f"wide {H}x{D}": f"c2 decoder ODE {H}x{D} semilinear_fused" for H, D in WIDE}}
    names = {"K2": "fused_semilinear_fwd", "K3": "fused_semilinear_bwd", "K2-members": "fused_semilinear_fwd_members",
             "K3-members": "fused_semilinear_bwd_members"}
    for case, rec in c2.items():
        for key, t in rec.items():
            variant = (t["method"], *t["width"])
            main_path = c2_paths[case]
            n = VARIANT_PATHS[main_path][key][variant]
            check(args.rehearse or n > 0, f"C2 {case} {key}: its path {main_path!r} never launched {variant}")
            kernels.append({
                "name": f"{names[key]} ({t['method']}, H={t['width'][0]}, D={t['width'][1]})", "route": "cuda",
                "source": K2_SOURCE if key.startswith("K2") else K3_SOURCE,
                "replaces": K2_REPLACES if key.startswith("K2") else K3_REPLACES,
                "launches": n, "main_path": main_path, "max_abs_err": t["err"],
                "tolerance": {out: {"rule": TOLERANCE_RULES[key][out], "worst_error_over_tolerance": v}
                              for out, v in t["worst"].items()},
                "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"], "ptxas": t["ptxas"],
                **({"passes_of": t["passes_of"]} if "passes_of" in t else {}),
            })
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    if args.rehearse:
        print(json.dumps({"kernels": kernels}))
        print("rehearsal ok (no result: no card)")
        return
    print(json.dumps({"ranks": ranks}))
    if cards is not None:
        print(json.dumps({"cards": cards}))
    print(json.dumps({"graphs": graphed}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print_ok()


def print_ok() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()


def main_cards(device, rehearse: bool, smi: str) -> None:
    """``--cards``: phase 11 alone (after phases 1 and 2), on CVS data
    generated for it; fails where the machine has fewer than CARDS cards."""
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    try:
        data_dir = os.path.join(workdir, "cvs")
        make_dataset(data_dir, data_size=40 if rehearse else 1000, device=device)
        phase(f"11: the layouts across {CARDS} cards over NCCL")
        cards = phase_cards(device, workdir, data_dir, rehearse, smi, {})
        phase("done")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(cards is not None, f"--cards needs {CARDS} CUDA cards")
    print(json.dumps({"cards": cards}))
    if rehearse:
        print("rehearsal ok (no result: no card)")
        return
    print(smi)
    print_ok()


if __name__ == "__main__":
    main()
