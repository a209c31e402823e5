#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hig_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (or several):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is turned off so float32 products stay float32;
  2. build: nvcc builds every kernel library (B1-B4 and the ordered
     bfloat16 sum), one process per source, all started together; each
     kernel's registers, shared memory and spills from ptxas;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving shape (N = 16 sequences = 8 caption pairs, T = 91 tokens,
     D = 512, 8 heads, float32, ragged lengths): B1 self and interaction;
     B2; B3 through the model's ``_attend`` with 91 and 77 keys; B4 self
     (q, k, v read in place from one merged product), partner, causal, and
     91 queries on 77 keys (B3 also under LAZY_KNORM, the same kernel,
     against the lazy twin); B2 and B4 also at the training shape (128
     sequences: a PIT step's 32 pairs under both caption assignments), B1
     at the labeling shape (256 sequences), and B1 (self and interaction),
     B2 and B4 at the evaluation chunk's shape (104 sequences, T = 196,
     ragged). Each with its time, the plain version's time,
     the card's lower bound for the same work (``bound``: bytes, or
     float32-accurate operations at the faster of FMA and 3xTF32) and, for
     B4, the time of torch's scaled_dot_product_attention on the same
     inputs;
  4. denoiser: one full-width denoiser call through each kernel against the
     same call through the plain versions: efficient blocks through B1 and
     through B2, and the quadratic (--no_eff) denoiser through B4;
  5. serve: 8 caption-pair requests at full width with seeded random
     weights, DDIM-50, three times: --blocks fused, --blocks projected and
     --no_eff, through hig_tpu_torch.serve's functions and the sampler
     users get, one CUDA graph per shape: the capturing call (its warm-up
     denoiser call, capture seconds, the graph's pool), the launch counts
     of each of 3 timed replays (800 for the run's own kernel, 0 for every
     other), finite outputs of the right shape, the median wall time per
     call and peak memory; two calls of the eager loop (graph=False),
     timed, whose output must equal the replay's bit for bit and whose
     launch counts the replays' must equal; and agreement of the eager loop
     through the plain versions (a replay would run the kernels there);
  6. train: ``python -m hig_tpu_torch.train``'s main at full width (global
     batch 32 caption pairs, T = 91, CLIP frozen) on a seeded dataset in the
     reference's layout written to a temporary directory: PIT through B2 (6
     steps), PIT --no_eff through B4 (4 steps) and the supervised stage with
     a 0/1 label file (2 steps), each step after the first a replay of the
     run's CUDA graph (the first runs eagerly, then the capture: its
     seconds, warm-up seconds and pool). Each run's launch counts (16 a step
     of its own kernel, 0 of the others; a replay credits its capture's),
     finite losses in metrics.jsonl, the latest checkpoint, ms per step
     (the median leaves out the capturing step), pairs/s and peak device
     memory; PIT also run eagerly (``graph=False``) from the same seed, whose
     final parameters, Adam moments, metrics and launch counts the graphed
     run must equal bit for bit, with the eager step's ms beside; for
     the two PIT runs, one batch's loss and every gradient through the
     kernels against the plain route, at the run's initial weights and, with
     both routes also against a float64 plain route, at its trained ones;
     then 8 requests served from the PIT run's checkpoint through B1 (the
     sampler's capturing call: 800 launches and the warm-up's 16);
  7. pipeline: the paper's three stages through the port's entry points on
     the same dataset, every training run through its step's graph as in
     phase 6: (1-1) PIT with caption ids (``train --cap_id``, 6
     steps, B2); (1-2) ``python -m hig_tpu_torch.label``'s main, role
     discovery on 26 annotated clips and pseudo-labels of the 48 training
     clips through B1 (16 launches per denoiser forward, none of B2-B4),
     complete label files, and the scorer through B1 against the plain
     route on one batch; (1-3) the supervised stage on those labels with
     caption dropout, the loss-aware sampler and a validation pass (2 steps
     and one validation batch through B2, a finite val_loss line; loss and
     gradients against the plain route with a keep mask that drops some
     pairs); then 8 requests served with classifier-free guidance (w =
     GUIDANCE) from stage 1-3's checkpoint through B1 (one denoiser call
     over the conditional and null pairs a step: 800 launches a DDIM-50
     call), graphed against the eager loop as in phase 5 and the eager
     loop against the plain route, and 8 from stage 1-1's caption-id
     checkpoint (w = 1, the capturing call: 816 launches);
  8. profile: the device time by kernel (torch.profiler) of one more
     serving call of each run, of the guided and caption-id serving calls,
     of the serving calls from the trained PIT checkpoints (float32 and
     bfloat16), of the first chunk of each
     ``evaluate`` run (float32 DDIM-50 guided, DPM-20, DDPM-1000; bfloat16
     DPM-20), of one labeling vote (a denoiser forward over 64 pairs under both
     assignments) and one more PIT training step, and of one bfloat16 PIT
     step and two bfloat16 labeling votes, fused (B1-bf16) and rms_norm
     projected (B2-bf16a) (phase 11). Every sampler call and both training
     steps there are replays of their graphs, whose launch counts the graph
     credits; beside them one eager call (float32 fused DDIM-50) and one
     eager step of each PIT run (float32 and bfloat16). The port
     kernels (``hig::``) that one wrapper call of each serving form launches,
     and one training call (forward and backward) of B2, B4, B3-bf16 and
     B4-bf16 and one ordered bfloat16 sum, are profiled first, by kernel
     name, and the trace of each sampler call and each training step must
     hold, name by name, its counts times that table. Each busy share
     divides by the unprofiled wall of its own kind of call (a step: the
     run's median replayed step). The profiler now and then loses device
     events, so a call is profiled again, at most 8 sessions, until its
     trace passes its check or two traces agree kernel by kernel (a table
     row: two must agree); "sessions" in each line. It runs last, after
     phase 11:
     once the profiler has run, later launches are slower;
  9. evaluate, on the same dataset plus a test split of 52 clips (two per
     class): ``python -m hig_tpu_torch.eval.train``'s main for the
     classifier and the consistency model at full width (8 layers, latent
     512, FFN 1024, 8 heads, batch 32, two epochs: no kernel launches,
     finite losses, the checkpoint, ms per step, peak memory, one batch's
     logits on the card against the CPU); ``python -m
     hig_tpu_torch.evaluate``'s main from stage 1-3's checkpoint three times
     (DDIM-50 guided w = GUIDANCE at T = 196, one replication; DPM-20 at
     T = 196; DDPM-1000 at T = 91), each with exactly 16 B1 launches per
     denoiser call and per captured graph's warm-up and none of the
     others, the graphs' capture seconds and pools, the first chunk of the
     DDIM and DPM runs replayed again and run through the eager loop (equal
     bit for bit, timed), finite metrics, Acc and
     Consistency in [0, 1], FID ≥ 0, confusion matrices of 52 clips, the
     five metrics in summary<run>.json, and for DDPM a peak memory below
     the size of the AdaLN grid it does not build; then DDPM-1000 at the
     serving shape through B1: the capture, a replay and the eager loop
     (equal bit for bit, the generator left in the same state), and the
     eager loop of a DDPM call over a DDPM_PLAIN_STEPS-step schedule
     through B1 against the same through the plain route (same x_T and step
     noises), with the wall time of each call.
 10. bf16 (after phase 9, before the profile; cuBLAS's reduced-precision
     bf16 reductions off): each bfloat16 form (B1-bf16 self and
     interaction, B2-bf16 self and partner, B3-bf16 through ``_attend``
     with 91 and 77 keys, B4-bf16 self, partner, causal and 91 queries on
     77 keys) and B2-bf16a (bfloat16 activations with float32 weights,
     self and partner) at the serving shape and at the evaluation chunk's
     shape, B2-bf16a also at the labeling shape (256 sequences) and
     B3-bf16 at the training shape (128 sequences, with its backward on the
     card against the same backward on the CPU, within one bfloat16 ulp of
     the largest gradient), B2-bf16a's weight split against its plain
     version bit for bit and timed alone, and the ordered bfloat16 sum of the bfloat16
     backwards at the training shape over the three axes they sum (bit for
     bit against its plain version, timed, with its bound), each form
     against its bfloat16 twin (max |err| ≤ 2 bfloat16 ulps of the twin's
     largest magnitude; rms(kernel − twin) ≤ 0.25 · rms(twin − the float32
     twin on the same rounded inputs), or 1.5 × the twin's distance from
     itself run on the CPU where the float32 order of sums alone moves more
     roundings than that), beside planted controls that must fail the same
     gates: B1-bf16's twin with one core rounding left out (four), B3-bf16's
     twin without one of its nine rounding points, and B2-bf16's twin with
     B1-bf16's core roundings (its core must be float32); timed as phase 3
     times (B1-bf16 also per launch: row pass, q|k|v projection + core,
     gate row pass, Wo GEMM), with its bound (each part at its own rate:
     bf16 989 TFLOP/s for products of bfloat16 values, 3xTF32 495 / 3 for
     B2-bf16's float32 core, 989 / 3 for B2-bf16a's float32-accurate
     products of bfloat16 activations and float32 weights) and, for
     B4-bf16, SDPA on the same bfloat16 inputs and the backend it took; one
     full-width bfloat16
     denoiser call each for fused (B1-bf16), projected (B2-bf16), no_eff
     (B4-bf16), rms_norm (B2-bf16) and fast_ln (B1-bf16): at 8 layers
     against the plain route in bfloat16 and in float32 (reported, with
     the plain route's own move under one bfloat16 ulp of one input
     element a pair), and cut to the first layer held to rms(kernels −
     plain bf16) ≤ 0.7 · rms(plain bf16 − plain float32) on the same
     inputs and weights, where the control route (the kernels' roundings
     left out) must fail for B1 and B4 (BF16_ROUTE_RMS says why); 8
     requests served in bfloat16, DDIM-50, for fused, projected, no_eff,
     rms_norm and guided w = GUIDANCE, graphed against the eager loop as
     in phase 5 (800 launches of the run's own form a replay, none of any
     other form or float32 kernel; the median wall of 3 replays; the same
     0.7 gate on the eager loop's plain route on the same x_T and weights,
     the control route's reading beside); and
     ``python -m hig_tpu_torch.evaluate`` from stage 1-3's checkpoint as a
     bfloat16 run with --fast_ln, DPM-20 at T = 196 (exactly 320 B1-bf16
     launches and one warm-up's 16, finite metrics in range, confusion
     matrices of 52 clips).
     The profile then adds the five bfloat16 serving runs' calls and the
     ``evaluate`` run's first chunk.
 11. bf16 train and label (after phase 10): ``python -m
     hig_tpu_torch.train``'s main at full width on phase 6's dataset with
     ``--compute_dtype bfloat16``: PIT (LayerNorm, 4 steps, B3-bf16), PIT
     with --rms_norm --fast_ln (2 steps, B3-bf16), PIT --no_eff (2 steps,
     B4-bf16) and the supervised stage with --cond_drop_prob 0.1 (2 steps
     and one validation batch, B3-bf16), every step after the first a
     replay of the run's graph, and PIT also eagerly beside it as in phase
     6 (bit for bit): 16 launches a step of the run's
     own form and none of any other form or float32 kernel, launches of the
     ordered bfloat16 sum (none in a float32 run; its kernel and its plain
     loop also timed in turns over eager bf16 PIT steps), finite losses,
     float32 parameters, Adam moments, EMA and checkpoint, ms per step,
     pairs/s and peak memory beside phase 6's float32 PIT step; for the
     three PIT runs, one batch's loss and every gradient through the
     kernels against the plain bfloat16 route at the model cut to its first
     layer, within BF16_TRAIN_RMS of the bfloat16 effect, beside a control
     route that must exceed it; the bfloat16 PIT step under LAZY_KNORM
     (B3-bf16's lazy forms) from the PIT run's initial weights, LAZY_STEPS
     steps graphed and eager bit for bit (16 launches a step of the lazy
     form, none of another), its first-layer gradients against the lazy
     plain route within BF16_TRAIN_RMS (the control above it), as is the
     same step without the flag; ``python -m hig_tpu_torch.label``'s main on
     the bfloat16 PIT checkpoint (--label_model and --save_label, fused:
     16 B1-bf16 launches per forward on the block weights cast per call)
     and on the rms_norm one (--label_model, projected: 16 B2-bf16a
     launches per forward), complete label files; both scorers on one
     batch against the plain route (held at the first layer to 0.7 of the
     bfloat16 effect, full depth reported); 8 requests served in bfloat16
     (DDIM-50, 816 B1-bf16 launches: a capturing call) from the bfloat16
     PIT checkpoint.
 12. ablations (after phase 11, before the profile): the paper's ablation
     models at full width. B2-bf16 at 392 rows (each pair's two actors end
     to end, as a --single_transformer model's self-attention sees them at
     the evaluation length) at 16 and 104 sequences against its twin under
     phase 10's gates beside its planted control, timed, with its bound;
     8 requests served, DDIM-50, on seeded weights: --no_cross_attn
     --blocks fused (B1, 400 launches a call), float32 --single_transformer
     at T = 91 (B2 at 182 rows, 400) and bfloat16 --single_transformer at
     T = 196 (B2-bf16 at 392 rows, 400), each graphed against the eager
     loop as in phase 5 (a capturing call 408, then 2 replays and 1 eager
     call), the float32 runs held to
     the plain route at SAMPLER_REL_TOL, the bfloat16 one to
     BF16_ROUTE_RMS of the bfloat16 effect as in phase 10; one labeling
     vote of the float32 --single_transformer model (8 B2 launches at 182
     rows) against the plain route; ``python -m hig_tpu_torch.train``'s
     main for 3 steps each of float32 PIT --no_cross_attn (B2) and
     bfloat16 PIT --single_transformer (B3-bf16 at 182 rows), graphed and
     eager from one seed bit for bit, one batch's loss and gradients held
     to the plain route as in phases 6 and 11; ``python -m
     hig_tpu_torch.train_single``'s main for 3 steps at batch 32, window
     60, t2m widths, on a seeded t2m-format dataset, graphed and eager bit
     for bit (8 B2 launches a step), then one ``make_single_sampler``
     DDIM-50 call of 8 captions at T = 196, graphed against eager bit for
     bit and against the plain route.
 13. options (after phase 12, before the profile): the single-chip options
     of a JAX run at full width. (a) The causal efficient model (seeded
     weights, --blocks fused, which a causal block ignores: it takes the
     causal core in plain PyTorch, as JAX's causal blocks take their einsum
     route) serving 8 requests, DDIM-50, in float32 and bfloat16, graphed
     against the eager loop as in phase 5 (2 replays, 1 eager call), no
     launch of any kernel; one denoiser call in float32 against the same in
     float64 (DENOISER_TOL), in bfloat16 cut to its first layer against its
     CPU twin within BF16_ROUTE_RMS of the bfloat16 effect; the profile
     adds one call of each. (b) ``python -m hig_tpu_torch.train``'s main,
     PIT --causal in float32 and bfloat16, 3 steps each, graphed and eager
     bit for bit (no kernel launch; the ordered bfloat16 sum in bfloat16),
     with step times, peak memory and the graph's pool. (c) One epoch of
     phase 6's clips (4 passes, 6 batches) through the Python and the
     native loader, batches/s of each; a native batch from 1 and 8 threads
     equal bit for bit; PIT --use_native_loader --window_size 60 (T = 61,
     B2, 3 steps) graphed and eager bit for bit. (d) A full-width state
     dict with the reference's key names (CLIP ViT-B/32 included, seeded)
     loaded by ``train --pretrained``: every converted leaf on the card
     equal to the dict's. (e) ``python -m hig_tpu_torch.add_cfg_branch`` on
     phase 6's supervised checkpoint (trained without caption dropout):
     unguided DDIM-50 serving of the graft equal to the donor's bit for
     bit (B1), then ``train --is_continue --cond_drop_prob 0.1`` from the
     graft for one step (B2). (f) ``python -m hig_tpu_torch.parity_smoke``
     on (d)'s state dict (DDIM-50, B2): full coverage, the probe's output
     against the same model's on the CPU within DENOISER_TOL, a finite
     decoded sample; ``python -m hig_tpu_torch.check_assets`` with no asset
     present.
 14. geometry (after phase 13, before the profile): the motion geometry,
     the JAX-free data tools and visualization. ``python -m
     hig_tpu_torch.make_synthetic_data`` (GEO_CLIPS_PER_CLASS clips a
     class, 90 to 197 frames: FK and the batched encode on the card), wall
     seconds beside the same with --device cpu, the two datasets held
     against each other (the same files, texts and splits byte for byte,
     features within GEO_FEAT_TOL, foot contacts and Mean/Std equal to it);
     GEO_PREPROCESS_CLIPS generator pairs (FK on the card) through ``python
     -m hig_tpu_torch.preprocess`` on the card: the encode's clips/s on the
     card and on the CPU, the features against the CPU's, encode →
     recover_from_ric2 against the generator's joints within
     GEO_ROUND_TRIP_TOL; PIT through ``python -m hig_tpu_torch.train`` on
     the port-made dataset (GEO_STEPS steps, 16 B2 launches a step, graphed;
     the loss-curve PNG's presence reported: the card's machine has no
     matplotlib); ``python -m hig_tpu_torch.visualize --no-gif
     --motion_length VIS_LENGTH`` from that checkpoint, DDIM-50 (816 B1
     launches: 800 and the capture's warm-up, none of another form), its
     wall time, its joints equal bit for bit to serve's decode of a replay
     of the same graph on the same seed; B3-bf16's whole and streaming
     forms timed side by side at 128 × 91 and 104 × 196 (equal bit for
     bit) and the streaming form at 64 × 394 against its twin beside the
     planted controls, with the bound; the lazy forms (LAZY_KNORM) at 128 ×
     91 (whole and streaming, equal bit for bit) and 64 × 394 (streaming)
     against the lazy twin (the elements that differ counted; phase 10's
     gates), beside the eager forms' times and controls that must fail
     (the eager twin, the lazy twin without its state's roundings); and
     one bfloat16
     --single_transformer PIT step at a native window of 196 (394 merged
     rows, B3-bf16's streaming form) at full width cut to its first layer
     against the plain route on the card within BF16_TRAIN_RMS of the
     bfloat16 effect, the control route above it, and against the same
     step on the CPU within BF16_ROUTE_RMS.
 15. rest (after phase 14, before the profile): the rest of Queue A at full
     width. (a) ``python -m hig_tpu_torch.distill``'s main from phase 7's
     cfg_supervised run, one stage 50 -> 25, 2 steps of 32 pairs, with
     --distill_w 1 and 2.5 (exactly DISTILL_STEP_LAUNCHES a step: the
     fused teacher's 32 B1, the student's 16 B2), each stage's opt.txt;
     ``serve`` of each stage from its opt.txt (DDIM-25, unguided: 400 B1
     launches a call, 416 a capturing call; 3 more replays of the w = 1
     student timed); the distillation step at batch 32 graphed and eager
     from one seed (bit for bit, ms, the capture) and its first step's
     loss and student gradients through the kernels against the plain
     route (the train step's gates). (b) ``vb_terms_bpd`` and
     ``prior_bpd`` on a full-width batch against the CPU twin
     (LIKELIHOOD_TOL); ``calc_bpd_loop`` over a 100-step schedule through
     the fused denoiser (1600 B1 launches). (c) ``serve --fit_smpl`` of 2
     requests of 91 frames from the w = 2.5 stage on the 6890-vertex
     synthetic model (the fits' walls and objective evaluations, each a
     replay of the objective's CUDA graph); the camera stage's L-BFGS on
     the card graphed and eager (bit for bit) and against the CPU: its
     first 5 iterates within SMPL_ITERATE_TOL on SMPL-posed joints,
     reported on the served ones; a 5-iteration fit of the first request's
     joints on the card against the same on the CPU (final objective within
     1%); ``python -m hig_tpu_torch.render_smpl --no-gif`` on the joints.
     (d) ``CoEmbeddingEvaluator`` at the reference's widths on phase 9's
     52 test clips at T = 196 against its CPU twin (LEGACY_TOL), its ms,
     the matching score and R-precision of the first 32. SMPL and the
     legacy protocol launch no kernel.
 16. parallel (after phase 15, before the profile): B2's rectangular form
     (a tensor-parallel rank's (256, 512) q|k|v weights at 4 heads) at the
     serving shape against its plain version (float32) and its twins
     (bfloat16, B2-bf16a), then ``PAR_RANKS`` processes of this script
     (``--parallel-rank``) on cuda:0 over gloo (NCCL refuses two ranks on
     one device) at full width from seed PAR_SEED, caption ids: (a) DP,
     two PIT steps at global batch 32 (losses equal across ranks bit for
     bit and within TRAIN_LOSS_TOL of the one-rank eager step, 16 B2
     launches a step on each rank); (b) FSDP (1 x 2), one step (shards of
     ``_leaf_spec``'s shapes; loss, gradients and the updated weights as
     DP's first step); (c) TP (1 x 2), a DDIM-25 call (PAR_TP_STEPS) for
     PAR_REQUESTS requests, 400 launches of B2's rectangular form on each
     rank and none of another kernel, within SAMPLER_REL_TOL of the one-rank
     projected call; (d) PP (1 x 2, pp_micro 2), one PIT step's loss and gradients
     against the sequential stack on the rank; (e) ``serve`` over 2 data
     ranks (8 requests each, B1), the primary's files within
     SAMPLER_REL_TOL of one-rank serving; (f) ``python -m
     hig_tpu_torch.train_single --distributed`` on phase 12's data, two
     steps of 48 over the 2 data ranks (the weights equal across ranks bit
     for bit, the losses within TRAIN_LOSS_TOL of one rank's, 8 B2 launches
     a step); (g) ``python -m hig_tpu_torch.distill`` over the 2 data ranks
     from phase 7's cfg_supervised run, one step (the stage's loss within
     TRAIN_LOSS_TOL of one rank's, DISTILL_STEP_LAUNCHES on each rank); (h)
     ``train --pretrained``'s load of phase 13's reference state dict with
     --fsdp and with --tp (1 x 2): the gathered state bit for bit the
     one-rank load's, one PIT step equal across ranks and within
     TRAIN_LOSS_TOL of one rank's. The ranks start with the phase,
     after phase 15; the one-rank counterparts run on the card while the
     ranks start up and run; a failing rank fails the phase. Two ranks on
     one card time nothing about scaling.
Then the kernel table (the bfloat16 forms' rows after the float32 ones, and
phase 12's, 13's, 14's and 15's launches added; B3-bf16's row with both forms'
times under "forms"; its lazy forms' row, their launches phase 11's lazy
step's; B2's rectangular form's row, its launches phase 16's TP call's on
rank 0), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero without
that line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS, T, D, HEADS = 8, 91, 512, 8
LENGTHS = (90, 84, 77, 63, 90, 51, 35, 70)  # frames; T = max + 1 (init token)
DDIM_STEPS = 50
LAUNCHES_PER_CALL = 8 * 2 * DDIM_STEPS  # layers × kernel blocks × steps
# The graphed sampler's first call of a shape warms up with one denoiser
# call (16 launches, real and counted) before it captures; its capture
# launches nothing, and each replay credits the eager call's counts.
FIRST_CALL = LAUNCHES_PER_CALL + 8 * 2
SERVE_CALLS = 3  # timed serving calls per serving run
TK_SHORT = 77  # keys of the Tq != Tk kernel checks
# serving run → the kernel its self-attention and interaction blocks launch
SERVE_RUNS = {"fused": "fused_block", "projected": "projected_attention",
              "no_eff": "flash_attention"}
# Training runs at full width, global batch 32, T = 91: run → (extra
# arguments of python -m hig_tpu_torch.train, steps, the kernel its attention
# blocks launch). 48 clips: 4 passes make 6 batches of 32, 3 passes 4; the
# supervised stage keeps 32 clips for 2 passes, 2 batches.
TRAIN_PAIRS, TRAIN_CLIPS = 32, 48
TRAIN_RUNS = {
    "pit": (["--times", "4"], 6, "projected_attention"),
    "pit_no_eff": (["--times", "3", "--no_eff"], 4, "flash_attention"),
    "supervised": (["--times", "2", "--limit_data_num", "32", "--label_path",
                    "{data}/labels.json"], 2, "projected_attention"),
}
LAUNCHES_PER_STEP = 8 * 2  # layers × (self-attention, interaction): one forward a step
# Kernel route against plain route on one batch: the backwards recompute the
# plain versions, so only the forwards' float32 rounding (≤ 2e-5 per kernel)
# differs, carried through 8 layers and the loss. The key biases' exact
# gradient is 0 (a softmax over the keys ignores a constant added to every
# key), so those leaves hold rounding noise, bounded against the model's
# largest gradient. Every other leaf is held to TRAIN_GRAD_TOL of its own
# largest magnitude at the run's initial (seeded) weights. After a few steps
# the text cross-attention's gradients fall to ~5e-6 of the model's largest,
# where float32 itself misses a float64 reference by ~1e-3 of the leaf in
# either route, so at the trained weights the per-leaf errors are reported,
# beside both routes' errors against float64, and not held to the tolerance.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_ZERO_GRAD_TOL = 1e-4, 1e-3, 1e-6
KEY_BIAS = "_block.key.bias"
# With caption ids the text is one token, over which the efficient text
# cross-attention returns the token's value whatever the query: its query,
# key and norm have an exact gradient of 0 too.
CAP_ID_ZERO_GRAD = (KEY_BIAS, ".ca_block.key.weight", ".ca_block.query.weight",
                    ".ca_block.query.bias", ".ca_block.norm.weight", ".ca_block.norm.bias")
# The three-stage pipeline (phase 7) on the same dataset: the annotated split
# has one clip per class, the validation split VAL_CLIPS clips (one batch).
ANN_CLIPS, VAL_CLIPS = 26, 32
LABEL_BATCH = 64  # the label CLI's default: one batch of each split
GUIDANCE = 2.5
# The evaluation (phase 9): the test split has two clips per class, all in
# one generation chunk; generation runs at the evaluation length (the
# default --gen_T, max_motion_length) except the DDPM-1000 run.
EVAL_CLIPS, EVAL_T = 52, 196
# evaluate run → (arguments of python -m hig_tpu_torch.evaluate, denoiser
# calls a replication, replications)
EVAL_RUNS = {
    "ddim_guided": (["--sampler", "ddim", "--guidance_scale", str(GUIDANCE),
                     "--replication_times", "1"], DDIM_STEPS, 1),
    "dpm20": (["--sampler", "dpm", "--ddim_steps", "20"], 20, 1),
    "ddpm1000": (["--sampler", "ddpm", "--gen_T", str(T)], 1000, 1),
}
METRICS = ("Acc", "Consistency", "FID", "Diversity", "MultiModality")
# Evaluator logits on the card against the same model on the CPU (TF32 off):
# 8 post-LN layers over 182 tokens, float32 sums in another order.
EVAL_LOGITS_REL_TOL = 1e-4
# the DDPM serving call's kernels against the plain route over a schedule of
# this many steps (the 1000-step call is graphed against the eager loop)
DDPM_PLAIN_STEPS = 250
CAP_ID_RUN = (["--cap_id", "--times", "4"], 6, "projected_attention")
CFG_RUN = (["--times", "2", "--limit_data_num", "32", "--label_path", "{data}/pseudo_labels.json",
            "--cond_drop_prob", "0.1", "--loss_aware_sampler", "--eval_every_e", "1",
            "--result_path", "{tmp}/result"], 2, "projected_attention")
# Card rates for the bound, H100 SXM (NVIDIA data sheet): float32 FMA
# without tensor cores, dense TF32 on the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_SPLIT = 3  # a float32-accurate product in 3xTF32 takes three TF32 ones
PEAK_BYTES = 3.35e12
# Kernel vs plain version, float32: sums run in another order and the
# block's second LayerNorm rescales y by 1/std(y) (~30 at these inputs).
KERNEL_TOL = 1e-4
# Full-width denoiser, 8 layers of 4 blocks: the per-block differences add up.
DENOISER_TOL = 1e-3
# DDIM-50 output with random weights, relative to max |plain|: each step
# multiplies x by c1 ≥ 1, so differences of the first steps grow.
SAMPLER_REL_TOL = 1e-3
# Guided DDIM-50: e_u + w·(e_c − e_u) scales the two passes' rounding by up
# to |1 − w| + w (4 at w = 2.5), so the guided run may miss the plain route
# by up to that multiple of SAMPLER_REL_TOL; it is held to SAMPLER_REL_TOL.
GUIDED_REL_TOL = SAMPLER_REL_TOL


def fail_if(failures: list, cond: bool, what: str) -> None:
    if cond:
        failures.append(what)
        print(json.dumps({"check_failed": what}), flush=True)


def time_ms(fn, warmup: int = 3, calls: int = 20, repeats: int = 5) -> float:
    """Device ms per call: ``calls`` back-to-back calls captured in one CUDA
    graph after ``warmup`` eager calls, CUDA events around a replay, divided
    by ``calls``; the median of ``repeats`` replays. A replay launches the
    captured kernels without the host, so the wrapper's host work (checks,
    ctypes) does not count where it is slower than the kernel it launches;
    the small device ops a wrapper adds (mask copies) do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str, str]:
    """The least time the card could take for ``flops`` float32-accurate
    operations on ``nbytes`` of input and output: the larger of the bytes'
    time and the operations' time, where the operations run at the faster
    of the two float32-accurate rates (FMA, or TF32 / 3 for 3xTF32). Returns
    (ms, "operations" or "bytes", and what bounds it: "ops_fma",
    "ops_3xtf32" or "bytes")."""
    t_fma, t_3x = flops / PEAK_F32_FLOPS, TF32_SPLIT * flops / PEAK_TF32_FLOPS
    t_ops, t_bytes = min(t_fma, t_3x), nbytes / PEAK_BYTES
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "bytes"
    return t_ops * 1e3, "operations", ("ops_3xtf32" if t_3x <= t_fma else "ops_fma")


def wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name."""
    from hig_tpu_torch.ops.flash_attention import flash_attention
    from hig_tpu_torch.ops.fused_block import fused_attention_block
    from hig_tpu_torch.ops.pallas_attention import (
        fused_efficient_attention,
        fused_projected_attention,
    )

    return {"fused_block": fused_attention_block,
            "projected_attention": fused_projected_attention,
            "efficient_attention": fused_efficient_attention,
            "flash_attention": flash_attention}


def unrounded(fn):
    """``fn`` on float32 upcasts of its bfloat16 arguments, the output
    rounded to bfloat16: a plain version with its own roundings left out."""
    from hig_tpu_torch.ops.fused_block import BlockWeights

    def up(a):
        if isinstance(a, BlockWeights):
            return BlockWeights(*[t.float() for t in a])
        return a.float() if torch.is_tensor(a) and a.is_floating_point() else a

    return lambda *args, **kw: fn(*map(up, args), **{k: up(v) for k, v in kw.items()}) \
        .to(torch.bfloat16)


@contextlib.contextmanager
def plain_blocks(control: bool = False):
    """Route the attention blocks through the plain versions (on any device),
    and the bfloat16 backwards' ordered sums through ``bf16_sum_plain``;
    with ``control``, the blocks through ``unrounded`` plain versions (phase
    10's control route)."""
    from hig_tpu_torch.models import attention
    from hig_tpu_torch.ops import flash_attention, fused_block, pallas_attention

    plain = {"fused_attention_block": fused_block.fused_attention_block_plain,
             "fused_projected_attention": pallas_attention.fused_projected_attention_plain,
             "fused_efficient_attention": pallas_attention.fused_efficient_attention_plain,
             "flash_attention": flash_attention.flash_attention_plain}
    if control:
        plain = {name: unrounded(fn) for name, fn in plain.items()}
    saved = {name: getattr(attention, name) for name in plain}
    for name, fn in plain.items():
        setattr(attention, name, fn)
    try:
        with plain_sum():
            yield
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


@contextlib.contextmanager
def lazy_knorm(value: bool = True):
    """The port's ``LAZY_KNORM`` set to ``value``, then restored."""
    from hig_tpu_torch.models import attention

    saved = attention.LAZY_KNORM
    attention.LAZY_KNORM = value
    try:
        yield
    finally:
        attention.LAZY_KNORM = saved


@contextlib.contextmanager
def plain_sum():
    """The bfloat16 backwards' ordered sums through ``bf16_sum_plain``."""
    from hig_tpu_torch.models import embeddings
    from hig_tpu_torch.ops.bf16_sum import bf16_sum_plain

    saved = embeddings.bf16_sum
    embeddings.bf16_sum = bf16_sum_plain
    try:
        yield
    finally:
        embeddings.bf16_sum = saved


# A torch.profiler session on the H100 now and then loses device events:
# a short one all or some of them (its host events intact), a long one a
# stretch (one denoiser block's kernels of a 20-step call, every kind short
# by the same stretch), up to three sessions in a row (profile_sessions.py
# shows them). Every call profiled here launches the same kernels each time
# it runs, so a session is taken again (``kept_session``, up to
# PROFILE_SESSIONS, each retake after RETAKE_PAUSE_S) unless its trace passes
# its check or equals an earlier session's trace, kernel by kernel: two
# equal traces are the call's, and are held to the check as they are.
PROFILE_SESSIONS, RETAKE_PAUSE_S = 8, 1.0


def kept_session(session, held=None, sessions: int = PROFILE_SESSIONS,
                 pause_s: float = RETAKE_PAUSE_S) -> tuple:
    """``session()`` (one profiled call: ({kernel name: device events}, ...))
    until its trace is kept, at most ``sessions`` times. A trace without
    a device event is never kept; one that passes ``held(result)`` is, and
    so is one equal to an earlier session's (``held`` None: only that, so
    the second session is no retake). Returns (the last result, the
    sessions taken, whether it was kept)."""
    seen = []
    for taken in range(1, sessions + 1):
        if taken > (1 if held is not None else 2):
            time.sleep(pause_s)
        out = session()
        trace = out[0]
        if trace:
            if (held is not None and held(out)) or trace in seen:
                return out, taken, True
            seen.append(trace)
    return out, sessions, False


def profile_call(fn, check: bool = False, before=None, held=None) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler). Only
    device activity is recorded: host op events would add ~30,000 events
    to a call and some 15 s to their summary, and no number here reads
    them. The device events are summed as the profiler hands them over: its
    own summary (``key_averages``) builds a Python object per event, 30-40 s
    for the 200,000 of a DDPM-1000 call. With ``check`` that summary is
    built as well, and "summary_agrees" says whether it reads the same
    count and time (to 1e-6) of every kernel. The call runs again, with
    ``before()`` (if given) ahead of each run, until ``kept_session`` keeps
    its trace (``held`` gets this function's result for the session);
    "sessions" and "kept" say how it went."""
    from torch.profiler import ProfilerActivity, profile

    def session():
        if before is not None:
            before()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name: dict = {}
        for e in prof.profiler.kineto_results.events():
            if "CUDA" in str(e.device_type()):
                ms_n = by_name.setdefault(e.name(), [0.0, 0])
                ms_n[0] += (e.end_ns() - e.start_ns()) / 1e6
                ms_n[1] += 1
        out = summarize(by_name, wall_ms)
        return {name: n for name, (_, n) in by_name.items()}, out, prof

    (_, out, prof), taken, kept = kept_session(
        session, None if held is None else lambda result: held(result[1]))
    out.update(sessions=taken, kept=kept)
    if check:
        summary = {e.key: (e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if "CUDA" in str(e.device_type)
                   and e.self_device_time_total > 0 and e.count > 0}
        kernels = out.pop("_kernels")
        out["summary_agrees"] = summary.keys() == {k[0] for k in kernels} and all(
            summary[name][1] == n and abs(summary[name][0] - ms) <= 1e-6 * ms
            for name, ms, n in kernels)
    out.pop("_kernels", None)
    return out


def summarize(by_name: dict, wall_ms: float) -> dict:
    """``profile_call``'s numbers from {kernel name: [ms, events]}."""
    kernels = sorted(((name, ms, n) for name, (ms, n) in by_name.items() if ms > 0),
                     key=lambda k: -k[1])
    port = [k for k in kernels if "hig::" in k[0]]
    return {"profiled_wall_ms": wall_ms, "device_ms": sum(k[1] for k in kernels),
            "port_kernels_ms": sum(k[1] for k in port),
            "port_kernel_launches": sum(k[2] for k in port),
            "port_kernels": {name: n for name, _, n in sorted(port)},
            "top": [[name[:90], ms, n] for name, ms, n in kernels[:16]], "_kernels": kernels}


def serve_with(sample_fn, requests, mean, std, cap_id: bool = False):
    """``call(gen)``: the requests served through ``sample_fn`` from ``gen``."""
    from hig_tpu_torch import serve

    def call(gen):
        return serve.serve_batch(sample_fn, requests, mean, std, torch.device("cuda"), gen,
                                 cap_id)

    return call


def seeded(call, seed: int = 0):
    """``call`` on a fresh CUDA generator seeded ``seed``, for the profile."""
    return lambda: call(torch.Generator(device="cuda").manual_seed(seed))


def graph_and_eager(label: str, call, eager, graphs: dict, failures, replays: int = SERVE_CALLS,
                    eager_calls: int = 2):
    """A serving run through the graphed sampler beside the eager loop.
    ``call(gen)`` serves through the graphed sampler (``graphs``: its
    ``sample.graphs``), ``eager(gen)`` the same requests through the same
    model's ``graph=False`` sampler, each from a CUDA generator seeded 0.
    The first call captures; ``replays`` replays are timed, each with every
    launch count set to 0 before it and read after; then ``eager_calls``
    eager calls (the wall: their median), whose output must equal the last
    replay's bit for bit, the generator left in the same state, and whose
    counts every replay must equal.
    Peak memory: ``torch.cuda.max_memory_allocated`` over a call (the
    model's weights included), and for the graphed call the graph's pool
    beside it (a replay allocates nothing in the pool: its blocks were
    reserved at the capture). Returns (the row, the last replay's
    (features, joints), the first call's counts, the replays' counts)."""
    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        out = fn(gen)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, bf16_counts(), torch.cuda.max_memory_allocated(),
                gen.get_state())

    _, first_s, first_counts, _, _ = timed(call)
    runs = [timed(call) for _ in range(replays)]
    out, _, _, peak, state = runs[-1]
    eagers = [timed(eager) for _ in range(eager_calls)]
    _, _, eager_counts, eager_peak, _ = eagers[0]
    same = all(all(np.array_equal(a, b) for a, b in zip(out, e[0])) and torch.equal(state, e[4])
               for e in eagers)
    (capture,) = [c.summary() for c in graphs.values()]
    walls = [r[1] for r in runs]
    eager_walls = [e[1] for e in eagers]
    row = {"capture": capture, "first_call_s": first_s, "launches_first_call": first_counts,
           "wall_s_per_call": statistics.median(walls), "wall_s_calls": walls,
           "eager_wall_s": statistics.median(eager_walls), "eager_wall_s_calls": eager_walls,
           "eager_launches": eager_counts,
           "peak_allocated_gb": peak / 1e9, "graph_pool_gb": capture["pool_bytes"] / 1e9,
           "eager_peak_allocated_gb": eager_peak / 1e9, "graph_equals_eager": same}
    fail_if(failures, not same, f"{label}: the replayed call differs from the eager loop")
    fail_if(failures, not capture["pool_bytes"] > 0,
            f"{label}: graph pool {capture['pool_bytes']} B")
    fail_if(failures, any(r[2] != eager_counts for r in runs + eagers),
            f"{label}: replayed launches {[r[2] for r in runs]}, eager "
            f"{[e[2] for e in eagers]}")
    return row, out, first_counts, [r[2] for r in runs]


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    }), flush=True)
    return smi


def phase_build() -> None:
    from hig_tpu_torch.ops import _build

    log = _build.build_all()
    ptxas = {lib: ptxas_lines(text) for lib, text in log.items() if lib != "seconds"}
    print(json.dumps({"phase": "build", "seconds": log["seconds"], "ptxas": ptxas}),
          flush=True)


def ptxas_lines(text: str) -> dict:
    """nvcc -Xptxas -v output → {kernel (mangled name): "registers, shared
    memory, spills"}."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = f"{out[name]}; {ln.strip()}" if name in out else ln.strip()
    return out


def block_inputs(device, pairs: int = N_PAIRS, tq: int = T):
    """Seeded block weights and (pairs, 2, tq, D) inputs, lengths LENGTHS
    repeated (scaled from T to tq), AdaLN (scale, shift)."""
    gen = torch.Generator().manual_seed(1)
    from hig_tpu_torch.ops.fused_block import BlockWeights

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen)).to(device)

    w = BlockWeights(
        1 + randn(D, std=0.1), randn(D, std=0.1),
        randn(D, D, std=D ** -0.5), randn(D, std=0.1),
        randn(D, D, std=D ** -0.5), randn(D, std=0.1),
        randn(D, D, std=D ** -0.5), randn(D, std=0.1),
        1 + randn(D, std=0.1), randn(D, std=0.1),
        randn(D, D, std=D ** -0.5), randn(D, std=0.1),
    )
    x = randn(pairs, 2, tq, D)
    frames = [L * (tq - 1) // (T - 1) for L in LENGTHS * -(-pairs // N_PAIRS)][:pairs]
    lengths = torch.tensor(frames, device=device) + 1
    mask = (torch.arange(tq, device=device) < lengths[:, None]).float()[:, None, :]
    mask = mask.expand(pairs, 2, tq).contiguous()
    scale, shift = randn(pairs, 2, 1, D, std=0.5), randn(pairs, 2, 1, D, std=0.5)
    return w, x, mask, scale, shift


def phase_kernels(device, failures) -> dict:
    rows = {"fused_block": check_fused_block(*block_inputs(device), failures)}
    w, x, mask, _, _ = block_inputs(device)
    rows["projected_attention"] = check_projected_attention(w, x, mask, failures)
    rows["efficient_attention"] = check_efficient_attention(w, x, mask, failures)
    rows["flash_attention"] = check_flash_attention(w, x, mask, failures)
    # B2 and B4 at the training shape: a PIT step denoises its TRAIN_PAIRS
    # pairs under both caption assignments (2 × 32 pairs, 128 sequences)
    w, x, mask, _, _ = block_inputs(device, 2 * TRAIN_PAIRS)
    for name, check in (("projected_attention", check_projected_attention),
                        ("flash_attention", check_flash_attention)):
        rows[name]["train_shape"] = {k: v for k, v in check(w, x, mask, failures).items()
                                     if k in TRAIN_SHAPE_KEYS}
    # B1 at the labeling shape: a vote denoises LABEL_BATCH pairs under both
    # caption assignments (2 × 64 pairs, 256 sequences)
    rows["fused_block"]["label_shape"] = {
        k: v for k, v in check_fused_block(*block_inputs(device, 2 * LABEL_BATCH),
                                           failures).items() if k in TRAIN_SHAPE_KEYS}
    # B1, B2 and B4 at the evaluation chunk's shape: the 52 test pairs (104
    # sequences) at the generation length T = 196, ragged
    inputs = block_inputs(device, EVAL_CLIPS, EVAL_T)
    rows["fused_block"]["eval_shape"] = {
        k: v for k, v in check_fused_block(*inputs, failures).items() if k in TRAIN_SHAPE_KEYS}
    for name, check in (("projected_attention", check_projected_attention),
                        ("flash_attention", check_flash_attention)):
        rows[name]["eval_shape"] = {k: v for k, v in check(*inputs[:3], failures).items()
                                    if k in TRAIN_SHAPE_KEYS}
    return rows


TRAIN_SHAPE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def check_fused_block(w, x, mask, scale, shift, failures) -> dict:
    """B1, self-attention and interaction variants; the slower one's time."""
    from hig_tpu_torch.ops.fused_block import fused_attention_block, fused_attention_block_plain

    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    M = N * Tq
    attn_flops = 2 * 2 * N * HEADS * Tq * hd * hd
    errs, ms, plain_ms = [], [], []
    for interaction in (False, True):
        args = (x, mask, scale, shift, w, HEADS, interaction)
        got = fused_attention_block(*args)
        want = fused_attention_block_plain(*args)
        torch.cuda.synchronize()
        errs.append((got - want).abs().max().item())
        ms.append(time_ms(lambda: fused_attention_block(*args)))
        plain_ms.append(time_ms(lambda: fused_attention_block_plain(*args)))
    flops = 2 * M * D * 3 * D + 2 * M * D * D + attn_flops
    nbytes = 4 * (2 * M * D + M + 2 * N * D + 4 * D * D + 8 * D)
    b_ms, b_by, b_kind = bound(flops, nbytes)
    print(json.dumps({"phase": "kernel", "kernel": "fused_block",
                      "shape": [N, Tq, D, HEADS], "tol": KERNEL_TOL,
                      "max_abs_err_self": errs[0], "max_abs_err_interaction": errs[1],
                      "ms_self": ms[0], "ms_interaction": ms[1],
                      "plain_ms_self": plain_ms[0], "plain_ms_interaction": plain_ms[1],
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                      "bound_us": b_ms * 1e3, "bound_by": b_by,
                      "bound_kind": b_kind}), flush=True)
    fail_if(failures, not max(errs) <= KERNEL_TOL,
            f"fused_block {N} sequences max |err| {max(errs)}")
    return {
        "name": "fused_block", "route": "cuda", "source": "hig_tpu_torch/csrc/fused_block.cu",
        "replaces": "hig_tpu/ops/fused_block.py:48", "max_abs_err": max(errs),
        "ms": max(ms), "plain_ms": max(plain_ms), "bound_ms": b_ms, "bound_by": b_by,
        "bound_kind": b_kind, "library_ms": None,
    }


def check_projected_attention(w, x, mask, failures) -> dict:
    """B2 as the interaction block calls it (kv from the partner, flipped)."""
    from hig_tpu_torch.ops.pallas_attention import (
        fused_projected_attention,
        fused_projected_attention_plain,
    )

    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    M = N * Tq
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    kv, kmask = xn.flip(1).contiguous(), mask.flip(1).contiguous()
    args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, HEADS, kmask)
    got = fused_projected_attention(*args)
    want = fused_projected_attention_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    k_ms = time_ms(lambda: fused_projected_attention(*args))
    p_ms = time_ms(lambda: fused_projected_attention_plain(*args))
    flops = 2 * M * D * 3 * D + 2 * 2 * N * HEADS * Tq * hd * hd
    nbytes = 4 * (3 * M * D + M + 3 * D * D + 3 * D)
    b_ms, b_by, b_kind = bound(flops, nbytes)
    print(json.dumps({"phase": "kernel", "kernel": "projected_attention",
                      "shape": [N, Tq, D, HEADS], "tol": KERNEL_TOL, "max_abs_err": err,
                      "ms": k_ms, "plain_ms": p_ms, "gflop": flops / 1e9,
                      "mbytes": nbytes / 1e6, "bound_us": b_ms * 1e3,
                      "bound_by": b_by, "bound_kind": b_kind}), flush=True)
    fail_if(failures, not err <= KERNEL_TOL, f"projected_attention {N} sequences max |err| {err}")
    return {
        "name": "projected_attention", "route": "cuda",
        "source": "hig_tpu_torch/csrc/projected_attention.cu",
        "replaces": "hig_tpu/ops/pallas_attention.py:116", "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_kind": b_kind, "library_ms": None,
    }


def check_efficient_attention(w, x, mask, failures) -> dict:
    """B3 through the model's ``_attend``, with 91 and with 77 keys."""
    from hig_tpu_torch.models import attention
    from hig_tpu_torch.ops.pallas_attention import efficient_attention

    F = torch.nn.functional
    N, hd = 2 * N_PAIRS, D // HEADS
    q, k, v = F.linear(x, w.wq, w.bq), F.linear(x, w.wk, w.bk), F.linear(x, w.wv, w.bv)
    cases = {}
    for Tk in (T, TK_SHORT):
        args = (q, k[..., :Tk, :].contiguous(), v[..., :Tk, :].contiguous(), HEADS,
                mask[..., :Tk].contiguous())
        got = attention._attend(*args)
        want = efficient_attention(*args)
        # LAZY_KNORM: the same kernel (it divides the state after the
        # contraction) against the lazy twin, and the eager twin beside
        with lazy_knorm():
            got_lazy = attention._attend(*args)
        want_lazy = efficient_attention(*args, lazy=True)
        torch.cuda.synchronize()
        lazy = {"max_abs_err": (got_lazy - want_lazy).abs().max().item(),
                "max_abs_err_vs_eager_twin": (got_lazy - want).abs().max().item(),
                "plain_ms": time_ms(lambda: efficient_attention(*args, lazy=True))}
        flops = 2 * N * HEADS * hd * hd * (T + Tk)
        nbytes = 4 * (2 * N * T * D + 2 * N * Tk * D + N * Tk)
        b_ms, b_by, b_kind = bound(flops, nbytes)
        cases[f"tk{Tk}"] = {
            "max_abs_err": (got - want).abs().max().item(),
            "ms": time_ms(lambda: attention._attend(*args)),
            "plain_ms": time_ms(lambda: efficient_attention(*args)),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": b_ms, "bound_by": b_by,
            "bound_kind": b_kind, "lazy": lazy,
        }
    err = max(c["max_abs_err"] for c in cases.values())
    lazy_err = max(c["lazy"]["max_abs_err"] for c in cases.values())
    print(json.dumps({"phase": "kernel", "kernel": "efficient_attention",
                      "shape": [N, T, D, HEADS], "tol": KERNEL_TOL, "cases": cases}),
          flush=True)
    fail_if(failures, not err <= KERNEL_TOL, f"efficient_attention max |err| {err}")
    fail_if(failures, not lazy_err <= KERNEL_TOL,
            f"efficient_attention against the lazy twin: max |err| {lazy_err}")
    full = cases[f"tk{T}"]
    return {
        "name": "efficient_attention", "route": "cuda",
        "source": "hig_tpu_torch/csrc/efficient_attention.cu",
        "replaces": "hig_tpu/ops/pallas_attention.py:46", "max_abs_err": err,
        "ms": full["ms"], "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "bound_kind": full["bound_kind"], "library_ms": None,
        "lazy": {"max_abs_err": lazy_err, "plain_ms": full["lazy"]["plain_ms"]},
    }


def check_flash_attention(w, x, mask, failures) -> dict:
    """B4 as the quadratic blocks call it (self: q, k, v read in place from
    one merged product; partner: k, v from a (.., 2D) product of the
    unflipped x), causal, and 91 queries on 77 keys; against the plain
    version, and torch's scaled_dot_product_attention timed on the same
    inputs (its mask as a float bias, the partner's k, v flipped first)."""
    from hig_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    F = torch.nn.functional
    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    qkv = F.linear(x, torch.cat([w.wq, w.wk, w.wv]), torch.cat([w.bq, w.bk, w.bv]))
    q, k, v = qkv.chunk(3, dim=-1)
    kv = F.linear(x, torch.cat([w.wk, w.wv]), torch.cat([w.bk, w.bv]))
    pk, pv = kv.chunk(2, dim=-1)
    short = (q.contiguous(), k[..., :TK_SHORT, :].contiguous(),
             v[..., :TK_SHORT, :].contiguous(), HEADS, mask[..., :TK_SHORT], False, False)
    cases = {"self": (q, k, v, HEADS, mask, False, False),
             "partner": (q, pk, pv, HEADS, mask, False, True),
             "causal": (q, k, v, HEADS, mask, True, False),
             f"tq{Tq}_tk{TK_SHORT}": short}

    def heads(t):  # (B, 2, T, D) → (N, H, T, hd), a view
        return t.reshape(N, t.shape[-2], HEADS, hd).transpose(1, 2)

    out = {}
    for name, args in cases.items():
        qq, kk, vv, _, m, causal, partner = args
        Tk = kk.shape[-2]
        got = flash_attention(*args)
        want = flash_attention_plain(*args)
        if partner:
            kk, vv, m = kk.flip(1), vv.flip(1), m.flip(1)
        bias = ((1.0 - m.reshape(N, 1, 1, Tk)) * -1e6).expand(N, 1, Tq, Tk)
        if causal:
            bias = bias + (torch.arange(Tk, device=x.device)[None, :]
                           > torch.arange(Tq, device=x.device)[:, None]) * -1e6
        sdpa_args = (heads(qq), heads(kk), heads(vv), bias.contiguous())
        lib = F.scaled_dot_product_attention(*sdpa_args[:3], attn_mask=sdpa_args[3])
        torch.cuda.synchronize()
        flops = 4 * N * HEADS * Tq * Tk * hd
        nbytes = 4 * (2 * N * Tq * D + 2 * N * Tk * D + N * Tk)
        b_ms, b_by, b_kind = bound(flops, nbytes)
        out[name] = {
            "max_abs_err": (got - want).abs().max().item(),
            "library_max_abs_err": (lib.transpose(1, 2).reshape(want.shape) - want)
            .abs().max().item(),
            "ms": time_ms(lambda: flash_attention(*args)),
            "plain_ms": time_ms(lambda: flash_attention_plain(*args)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *sdpa_args[:3], attn_mask=sdpa_args[3])),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": b_ms, "bound_by": b_by,
            "bound_kind": b_kind,
        }
    err = max(c["max_abs_err"] for c in out.values())
    print(json.dumps({"phase": "kernel", "kernel": "flash_attention",
                      "shape": [N, Tq, D, HEADS], "tol": KERNEL_TOL, "cases": out}), flush=True)
    fail_if(failures, not err <= KERNEL_TOL, f"flash_attention {N} sequences max |err| {err}")
    path = [out[c] for c in ("self", "partner", "causal")]  # the model's calls
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "hig_tpu_torch/csrc/flash_attention.cu",
        "replaces": "hig_tpu/ops/flash_attention.py:53", "max_abs_err": err,
        "ms": max(c["ms"] for c in path), "plain_ms": max(c["plain_ms"] for c in path),
        "bound_ms": path[0]["bound_ms"], "bound_by": path[0]["bound_by"],
        "bound_kind": path[0]["bound_kind"],
        "library_ms": max(c["library_ms"] for c in path),
    }


def phase_denoiser(models: dict, device, failures) -> None:
    gen = torch.Generator().manual_seed(2)
    cfg = models["fused"].cfg
    x = torch.randn((N_PAIRS, 2, T, cfg.input_feats), generator=gen).to(device)
    t = torch.full((N_PAIRS,), 500, device=device)
    lengths = torch.tensor(LENGTHS, device=device) + 1
    xf_proj = torch.randn((N_PAIRS, 2, cfg.time_embed_dim), generator=gen).to(device)
    xf_out = torch.randn((N_PAIRS, 2, 77, cfg.text_latent_dim), generator=gen).to(device)
    with torch.no_grad():
        for blocks, model in models.items():
            kv = model.text_kv(xf_out)
            got = model.denoise(x, t, lengths, xf_proj, text_kv=kv)
            with plain_blocks():
                want = model.denoise(x, t, lengths, xf_proj, text_kv=kv)
            err = (got - want).abs().max().item()
            print(json.dumps({"phase": "denoiser", "run": blocks, "tol": DENOISER_TOL,
                              "max_abs_err": err, "max_abs_out": want.abs().max().item()}),
                  flush=True)
            fail_if(failures, not err <= DENOISER_TOL, f"denoiser ({blocks}) max |err| {err}")


def serve_requests() -> list:
    """8 caption pairs of the NTU table with the lengths of LENGTHS."""
    from hig_tpu_torch.data.vocab import CLASSID2CAPS

    return [{"caption1": c1, "caption2": c2, "length": L, "id": f"req{i}"}
            for i, ((c1, c2), L) in enumerate(zip(CLASSID2CAPS, LENGTHS))]


def phase_serve(models: dict, device, failures) -> tuple[dict, dict, tuple]:
    """Phase 5. Returns the launch counts, {"serve_<run>": (graphed call,
    replayed wall s)} for the profile, and ("serve_fused_eager", the fused
    model's eager call, its wall s)."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train.trainer import make_sampler

    requests = serve_requests()
    sched = g.make_schedule(g.linear_betas(1000))
    mean, std = serve.load_stats(None, models["fused"].cfg.input_feats)
    kernels = wrappers()
    launches = {name: 0 for name in kernels}
    runs = {}
    for run_name, model in models.items():
        own = SERVE_RUNS[run_name]
        t_run = time.perf_counter()
        kw = dict(T=T, dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS)
        sample_fn = make_sampler(model, sched, **kw)
        run = serve_with(sample_fn, requests, mean, std)
        eager = serve_with(make_sampler(model, sched, graph=False, **kw), requests, mean, std)
        # The host clock varies from call to call (the machine's CPU cores
        # are shared), so the wall time is the median of a few calls.
        row, (features, joints), first, call_counts = graph_and_eager(
            f"serve ({run_name})", run, eager, sample_fn.graphs, failures)
        with plain_blocks():
            t1 = time.perf_counter()
            ref_features, _ = eager(torch.Generator(device=device).manual_seed(0))
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t1
        rel = float(np.abs(features - ref_features).max() / np.abs(ref_features).max())
        print(json.dumps({
            "phase": "serve", "run": run_name, "requests": len(requests), "T": T,
            "ddim_steps": DDIM_STEPS, "launches": call_counts[0], **row,
            "plain_wall_s_per_call": plain_wall,
            "features_shape": list(features.shape), "joints_shape": list(joints.shape),
            "finite": bool(np.isfinite(features).all() and np.isfinite(joints).all()),
            "max_abs_features": float(np.abs(features).max()),
            "rel_err_vs_plain": rel, "rel_tol": SAMPLER_REL_TOL,
            "seconds": time.perf_counter() - t_run,
        }), flush=True)
        fail_if(failures, any(c[name] != (LAUNCHES_PER_CALL if name == own else 0)
                              for c in call_counts for name in kernels),
                f"serve ({run_name}) launches {call_counts}")
        fail_if(failures, any(first[name] != (FIRST_CALL if name == own else 0)
                              for name in kernels),
                f"serve ({run_name}) launches of the capturing call {first}")
        fail_if(failures, tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3),
                f"serve ({run_name}) joints shape {joints.shape}")
        fail_if(failures, not (np.isfinite(features).all() and np.isfinite(joints).all()),
                f"serve ({run_name}) non-finite output")
        fail_if(failures, not rel <= SAMPLER_REL_TOL, f"serve ({run_name}) rel err {rel}")
        for name in kernels:
            launches[name] += call_counts[0][name]
        runs[f"serve_{run_name}"] = (seeded(run), row["wall_s_per_call"])
        if run_name == "fused":
            eager_run = ("serve_fused_eager", seeded(eager), row["eager_wall_s"])
    return launches, runs, eager_run


def sampler_run(run: str) -> bool:
    """A profiled run that is a sampler call: ``serve_*`` and ``evaluate_*``
    (each a replay of its graph, but for the one eager call)."""
    return run.startswith(("serve_", "evaluate_"))


def kernels_per_launch(device) -> tuple[dict, dict]:
    """({form: {port kernel name: launches}}, {form: (profiler sessions,
    kept)}): what
    one call of each wrapper form on the sampler's path launches on the card
    (torch.profiler), at the serving shape, as the denoiser's blocks call it
    (self-attention, not causal)."""
    from hig_tpu_torch.ops.flash_attention import flash_attention
    from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention

    F = torch.nn.functional
    w, x, mask, scale, shift = block_inputs(device)
    xn = F.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    table, sessions = {}, {}
    for suffix, cast in (("", torch.Tensor.float), ("_bf16", to_bf16)):
        wc = BlockWeights(*[cast(t) for t in w])
        q, k, v = F.linear(cast(x), torch.cat([wc.wq, wc.wk, wc.wv]),
                           torch.cat([wc.bq, wc.bk, wc.bv])).chunk(3, dim=-1)
        calls = {
            "fused_block": (fused_attention_block, cast(x), mask, cast(scale), cast(shift), wc,
                            HEADS),
            "projected_attention": (fused_projected_attention, cast(xn), cast(xn), wc.wq, wc.bq,
                                    wc.wk, wc.bk, wc.wv, wc.bv, HEADS, mask),
            "flash_attention": (flash_attention, q, k, v, HEADS, mask),
        }
        for form, (fn, *args) in calls.items():
            with torch.no_grad():
                prof = profile_call(lambda: fn(*args))
            table[form + suffix] = prof["port_kernels"]
            sessions[form + suffix] = (prof["sessions"], prof["kept"])
    return table, sessions


def train_kernels_per_launch(device) -> tuple[dict, dict]:
    """({form: {port kernel name: launches}}, {form: (profiler sessions,
    kept)}): what
    one training call of each form a train step launches on the card
    (torch.profiler), its forward and its backward, at the serving shape
    as the blocks call it: B2 (float32 efficient, self-attention), B4
    (``--no_eff``), B3-bf16 (bfloat16 efficient, the einsum route's core)
    and B4-bf16. The ordered bfloat16
    sums of the bfloat16 backwards count in ``bf16_sum.launches``, so they
    are taken out of their form's row and have their own (BF16_SUM, one
    call)."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum
    from hig_tpu_torch.ops.flash_attention import flash_attention
    from hig_tpu_torch.ops.pallas_attention import (
        fused_efficient_attention,
        fused_projected_attention,
    )

    F = torch.nn.functional
    w, x, mask, _, _ = block_inputs(device)
    xn = F.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    q, k, v = F.linear(x, torch.cat([w.wq, w.wk, w.wv]),
                       torch.cat([w.bq, w.bk, w.bv])).chunk(3, dim=-1)
    q, k, v = (t.contiguous() for t in (q, k, v))
    q16, k16, v16 = (to_bf16(t) for t in (q, k, v))
    prof = profile_call(lambda: bf16_sum(torch.randn((N_PAIRS, 2, T, D), device=device), -2))
    sum_row, sessions = prof["port_kernels"], {BF16_SUM: (prof["sessions"], prof["kept"])}
    table = {BF16_SUM: sum_row}

    def leaves(*ts):
        return [t.detach().requires_grad_() for t in ts]

    calls = {
        "projected_attention": lambda: (lambda a, *ws: fused_projected_attention(
            a, a, *ws, HEADS, mask))(*leaves(xn, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)),
        "flash_attention": lambda: flash_attention(*leaves(q, k, v), HEADS, mask),
        "efficient_attention_bf16": lambda: fused_efficient_attention(
            *leaves(q16, k16, v16), HEADS, mask),
        "flash_attention_bf16": lambda: flash_attention(*leaves(q16, k16, v16), HEADS, mask),
    }
    for form, call in calls.items():
        def fwd_bwd(call=call):
            out = call()
            out.backward(torch.ones_like(out))

        prof = profile_call(fwd_bwd, before=reset_counts)
        table[form] = without_sums(prof["port_kernels"], sum_row, bf16_sum.launches)
        sessions[form] = (prof["sessions"], prof["kept"])
    reset_counts()
    return table, sessions


def without_sums(traced: dict, sum_row: dict, sums: int) -> dict:
    """The port kernels of ``traced`` but those of its ``sums`` ordered
    bfloat16 sums (``sum_row`` each)."""
    row = dict(traced)
    for name, n in sum_row.items():
        row[name] = row.get(name, 0) - n * sums
    return {name: n for name, n in row.items() if n}


def train_step_run(run: str) -> bool:
    """A profiled run that is a replayed train step."""
    return run.startswith("train_step_")


def expected_port_kernels(counts: dict, per_launch: dict) -> dict | None:
    """The port kernels by name that ``counts`` launches of each form make
    (``kernels_per_launch``); None where a counted form has no entry."""
    want: dict = {}
    for form, n in counts.items():
        if form not in per_launch:
            return None
        for name, k in per_launch[form].items():
            want[name] = want.get(name, 0) + n * k
    return want


def phase_profile(runs: dict, eager: tuple, device, failures) -> None:
    """Phase 8. First what one wrapper call of each form launches, by
    kernel name (``kernels_per_launch``). Then one profiled call of each run
    in ``runs`` ({run: (call, its unprofiled wall s or None)}: serving calls,
    ``evaluate``'s first chunks, training steps and labeling votes) and of
    one eager sampler call (``eager``: (run, call, wall s)), every launch
    count set to 0 before the call and read after. A replay runs no Python
    per launch: its counts are those its graph credits. So the trace of each
    sampler call (``sampler_run``) must hold, kernel name by kernel name,
    its counts times the per-call table, the eager call's as well. The first
    run's trace is also read through the profiler's own summary, which must
    agree (``profile_call``). A trace that fails its check is the run's
    only once a second session's trace equals it kernel by kernel; till
    then the run is profiled again (``kept_session``), as is each table
    row till two agree. Each busy share is the device time over the
    unprofiled wall of the same kind of call. Profiling comes last: once the
    profiler has run, later launches in the process are slower, so no
    timing is taken after it."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum

    per_launch, sessions = kernels_per_launch(device)
    per_train_call, train_sessions = train_kernels_per_launch(device)
    sessions.update({f"train {form}": n for form, n in train_sessions.items()})
    print(json.dumps({"phase": "profile", "kernels_per_launch": per_launch,
                      "kernels_per_train_call": per_train_call, "sessions": sessions}),
          flush=True)
    for form, (_, kept) in sessions.items():
        fail_if(failures, not kept, f"profile: no two traces of one {form} call agree")

    def counted() -> dict:
        counts = {form: n for form, n in bf16_counts().items() if n}
        if bf16_sum.launches:
            counts[BF16_SUM] = bf16_sum.launches
        return counts

    eager_run, eager_call, eager_wall = eager
    todo = {**runs, eager_run: (eager_call, eager_wall)}
    # the DDPM-1000 calls last: after a trace of their ~200,000 device events
    # every later profile session on the H100 took ~8 s longer
    todo = dict(sorted(todo.items(), key=lambda item: "ddpm" in item[0]))
    for i, (run_name, (run, wall)) in enumerate(todo.items()):
        table = (per_launch if sampler_run(run_name)
                 else per_train_call if train_step_run(run_name) else None)

        def held(prof, table=table) -> bool:
            counts = counted()
            return table is None or (bool(counts) and
                                     expected_port_kernels(counts, table) == prof["port_kernels"])

        t_run = time.perf_counter()
        prof = profile_call(run, check=i == 0, before=reset_counts, held=held)
        fail_if(failures, prof.get("summary_agrees") is False,
                f"profile ({run_name}): the profiler's summary reads otherwise")
        fail_if(failures, not prof["kept"],
                f"profile ({run_name}): {prof['sessions']} sessions, none kept")
        prof["seconds"] = time.perf_counter() - t_run
        counts = counted()
        prof["launches"] = counts
        if wall is not None:
            prof["device_busy_share_unprofiled"] = prof["device_ms"] / (wall * 1e3)
        if counts:
            prof["port_kernels_ms_per_launch"] = prof["port_kernels_ms"] / sum(counts.values())
        if table is not None:
            want = expected_port_kernels(counts, table)
            prof["port_kernels_as_counted"] = want == prof["port_kernels"]
            fail_if(failures, not counts or want != prof["port_kernels"],
                    f"profile ({run_name}): the trace's port kernels {prof['port_kernels']}, "
                    f"its counts {counts} make {want}")
        print(json.dumps({"phase": "profile", "run": run_name, **prof}), flush=True)


def write_train_data(root: str, seed: int = 0) -> None:
    """A seeded dataset in the reference's layout: TRAIN_CLIPS clips of 60 to
    198 frames (+ the init row) of random 263-d features, caption pairs from
    the port's caption table, train_sub.txt, Mean.npy/Std.npy, and a 0/1
    label file for the supervised stage; then, for the pipeline, VAL_CLIPS
    clips in val_sub.txt and ANN_CLIPS annotated clips, one per class, in
    test_ann_ids.txt with seeded 0/1 role annotations in
    test_active_anns.json; for the evaluation, EVAL_CLIPS clips, two per
    class, in test_sub.txt."""
    from hig_tpu_torch.data.vocab import CLASSID2CAPS

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))

    def clips(prefix: str, count: int) -> list:
        names = []
        for i in range(count):
            name, frames = f"{prefix}{i:03d}", int(rng.integers(60, 199))
            motion = rng.standard_normal((2, frames + 1, 263), dtype=np.float32)
            np.save(os.path.join(root, "new_joint_vecs", name + ".npy"), motion)
            c1, c2 = CLASSID2CAPS[i % len(CLASSID2CAPS)]
            with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
                f.write(f"{c1}_{c2}#none#0.0#0.0\n")
            names.append(name)
        return names

    def split(name: str, names: list) -> None:
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(names) + "\n")

    names = clips("T", TRAIN_CLIPS)
    split("train_sub.txt", names)
    np.save(os.path.join(root, "Mean.npy"), np.zeros(267, np.float32))
    np.save(os.path.join(root, "Std.npy"), np.ones(267, np.float32))
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump({name: int(rng.integers(2)) for name in names}, f)
    split("val_sub.txt", clips("V", VAL_CLIPS))
    annotated = clips("A", ANN_CLIPS)
    split("test_ann_ids.txt", annotated)
    with open(os.path.join(root, "test_active_anns.json"), "w") as f:
        json.dump({name: int(rng.integers(2)) for name in annotated}, f)
    split("test_sub.txt", clips("E", EVAL_CLIPS))


def route_grads(model, sched, batch: dict, pit: bool, t, noise, plain: bool, keep=None):
    """Loss and every gradient of ``batch`` through the kernels or, with
    ``plain``, through the plain versions."""
    from hig_tpu_torch.train import trainer as tr

    with plain_blocks() if plain else contextlib.nullcontext():
        loss, _ = tr.compute_grads(model, tr.make_loss_fn(model, sched, pit), batch, t=t,
                                   noise=noise, keep=keep)
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def zero_grad_leaves(model) -> tuple:
    """Suffixes of the leaves whose exact gradient is 0: the key biases (a
    softmax over the keys ignores a constant added to every key) and, with
    caption ids, CAP_ID_ZERO_GRAD."""
    return CAP_ID_ZERO_GRAD if model.cfg.cap_id else (KEY_BIAS,)


def leaf_rel_errs(got: dict, want: dict, zero: tuple) -> dict:
    """max |got − want| over each leaf ÷ that leaf's max |want|, for every
    leaf but those of ``zero`` (exact gradient 0: rounding noise)."""
    return {name: float((got[name].double() - w).abs().max()) / float(w.abs().max())
            for name, w in want.items() if not name.endswith(zero)}


def grad_route_errors(model, sched, batch, pit: bool, float64: bool = False, keep=None) -> dict:
    """Loss and every gradient of one fixed batch (explicit t, noise and, for
    caption dropout, ``keep``) through the kernels against the plain
    versions, on the card. With ``float64``, both routes are also held
    against the plain versions in float64 (the model and batch cast), the
    reference of each leaf's float32 rounding."""
    device = batch["motion"].device
    gen = torch.Generator(device=device).manual_seed(5)
    B = batch["motion"].shape[0]
    t = torch.randint(0, 1000, (B,), generator=gen, device=device)
    noise = torch.randn(batch["motion"].shape, generator=gen, device=device)
    zero = zero_grad_leaves(model)
    loss_k, got = route_grads(model, sched, batch, pit, t, noise, plain=False, keep=keep)
    loss_p, want = route_grads(model, sched, batch, pit, t, noise, plain=True, keep=keep)
    scale = max(float(w.abs().max()) for w in want.values())
    rel = leaf_rel_errs(got, want, zero)
    worst = max(rel, key=rel.get)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "leaves": len(want),
           "same_leaves": got.keys() == want.keys(), "grad_rel_err_max": rel[worst],
           "grad_rel_err_worst_leaf": worst, "worst_leaf_max": float(want[worst].abs().max()),
           "grad_rel_err_median": statistics.median(rel.values()),
           "zero_grad_leaves_max": max(float(got[n].abs().max()) / scale
                                       for n in got if n.endswith(zero)),
           "grad_max": scale}
    if keep is not None:
        out["kept_pairs"] = int(keep.sum())
    if float64:
        model64 = copy.deepcopy(model).double()
        batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        loss_64, exact = route_grads(model64, sched, batch64, pit, t, noise.double(), plain=True)
        del model64, batch64
        k64, p64 = leaf_rel_errs(got, exact, zero), leaf_rel_errs(want, exact, zero)
        out["float64"] = {
            "loss": loss_64, "kernel_route_rel_err_max": max(k64.values()),
            "plain_route_rel_err_max": max(p64.values()),
            "at_worst_leaf": {"kernel_route": k64[worst], "plain_route": p64[worst]}}
    return out


def train_run(run: str, extra: list, steps: int, own: str, data: str, tmp: str, failures,
              smi: str, val_batches: int = 0, graph: bool = True,
              per_step: int = LAUNCHES_PER_STEP) -> tuple:
    """One run of ``python -m hig_tpu_torch.train``'s main at full width on
    the dataset in ``data``, its steps replayed from one CUDA graph (the
    first step eager, then the capture) or, without ``graph``, eager: its
    launch counts (``per_step`` a step of its own kernel, and as many a
    validation batch; 0 of every other form; the ordered bfloat16 sum
    launched in a bfloat16 run, in no other), steps, finite losses (and
    validation losses) in metrics.jsonl, the latest checkpoint, and for a
    graphed run one capture with a pool above 0 (its seconds and GB in the
    row; the graph is dropped after the run). Returns (trainer, state, the
    printed row without printing it, the counts with the sum's under
    BF16_SUM)."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum
    from hig_tpu_torch.train.__main__ import main as train_main

    argv = ["--name", run, "--data_root", data, "--checkpoints_dir", os.path.join(tmp, "runs"),
            "--batch_size", str(TRAIN_PAIRS), "--num_epochs", "1", "--log_every", "1",
            "--seed", "0", *[a.replace("{data}", data).replace("{tmp}", tmp) for a in extra]]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = train_main(argv, graph=graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captures = [c.summary() for c in trainer.graphs.values()]
    trainer.graphs.clear()  # its pool goes back to the allocator
    counts, sums = bf16_counts(), bf16_sum.launches
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.cfg
    with open(os.path.join(cfg.save_root, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [x["loss_mot_rec"] for x in lines if "loss_mot_rec" in x]
    val_losses = [x["val_loss"] for x in lines if "val_loss" in x]
    step_ms = [1e3 * x for x in trainer.step_seconds]
    steady = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    row = {"phase": "train", "run": run, "nvidia_smi": smi, "pairs_per_step": TRAIN_PAIRS,
           "T": T, "steps": state.step, "launches": {**counts, BF16_SUM: sums},
           "step_ms": step_ms,
           "median_ms_per_step_after_first": steady, "pairs_per_s": TRAIN_PAIRS * 1e3 / steady,
           "max_memory_allocated_gb": peak / 1e9, "losses": losses, "wall_s": wall,
           "params": sum(p.numel() for p in state.model.parameters()),
           "trainable": sum(p.numel() for p in state.optimizer.params), "graph": graph}
    if graph:
        row["captures"] = [{k: c[k] for k in ("warmup_s", "capture_s", "launches")}
                           | {"pool_gb": c["pool_bytes"] / 1e9} for c in captures]
        fail_if(failures, len(captures) != 1 or not captures[0]["pool_bytes"] > 0,
                f"train ({run}): captures {captures}")
    if val_batches:
        row["val_losses"] = val_losses
    want = per_step * (steps + val_batches)
    fail_if(failures, any(counts[n] != (want if n == own else 0) for n in counts),
            f"train ({run}) launches {counts}, expected {want} of {own}")
    fail_if(failures, (sums > 0) != (cfg.compute_dtype == "bfloat16"),
            f"train ({run}, {cfg.compute_dtype}) launched the ordered bfloat16 sum {sums} times")
    fail_if(failures, state.step != steps or len(losses) != steps,
            f"train ({run}) ran {state.step} steps, logged {len(losses)}")
    fail_if(failures, not all(np.isfinite(losses)), f"train ({run}) non-finite loss {losses}")
    fail_if(failures, val_batches and not (len(val_losses) == 1 and np.isfinite(val_losses[0])),
            f"train ({run}) validation losses {val_losses}")
    fail_if(failures, not os.path.exists(os.path.join(cfg.model_dir, "latest.pt")),
            f"train ({run}) wrote no latest checkpoint")
    return trainer, state, row, {**counts, BF16_SUM: sums}


def final_state_tensors(state) -> dict:
    """A run's parameters, Adam's moments and EMA, by name."""
    opt = state.optimizer
    out = {f"param.{n}": p.detach() for n, p in state.model.named_parameters()}
    out.update({f"exp_avg.{i}": m for i, m in enumerate(opt.exp_avg)})
    out.update({f"exp_avg_sq.{i}": v for i, v in enumerate(opt.exp_avg_sq)})
    out.update({f"ema.{n}": e for n, e in (state.ema or {}).items()})
    return out


def graphed_and_eager_run(run: str, extra: list, steps: int, own: str, data: str, tmp: str,
                          failures, smi: str, per_step: int = LAUNCHES_PER_STEP) -> tuple:
    """``train_run`` of ``run`` through the graph, then of the same
    arguments and seed eagerly (``graph=False``, as ``<run>_eager``): the
    eager run's final parameters, Adam moments and EMA, its metrics.jsonl
    and its launch counts must equal the graphed run's bit for bit (two
    eager runs do: no step of these runs sums with atomics). The graphed
    run's row gets the eager run's step times and peak memory under
    "eager". Returns what ``train_run`` returns for the graphed run."""
    trainer, state, row, counts = train_run(run, extra, steps, own, data, tmp, failures, smi,
                                            per_step=per_step)
    e_trainer, e_state, e_row, e_counts = train_run(f"{run}_eager", extra, steps, own, data,
                                                    tmp, failures, smi, graph=False,
                                                    per_step=per_step)
    got, want = final_state_tensors(state), final_state_tensors(e_state)
    differ = {n: float((got[n] - w).abs().max()) for n, w in want.items()
              if not torch.equal(got[n], w)}
    metrics = []
    for t in (trainer, e_trainer):
        with open(os.path.join(t.cfg.save_root, "metrics.jsonl")) as f:
            metrics.append([json.loads(line) for line in f])
    row["eager"] = {k: e_row[k] for k in ("step_ms", "median_ms_per_step_after_first",
                                          "pairs_per_s", "max_memory_allocated_gb", "wall_s")}
    row["graph_equals_eager"] = {"tensors": len(want), "differ": differ,
                                 "metrics": metrics[0] == metrics[1],
                                 "launches": counts == e_counts}
    fail_if(failures, bool(differ) or metrics[0] != metrics[1] or counts != e_counts
            or got.keys() != want.keys(),
            f"train ({run}): the graphed run differs from the eager run: "
            f"{row['graph_equals_eager']}, launches {counts} against {e_counts}")
    del e_trainer, e_state
    return trainer, state, row, counts


def gate_grad_check(failures, run: str, key: str, gc: dict) -> None:
    """Hold a grad_route_errors result to the TRAIN_* tolerances; at trained
    weights the per-leaf errors are reported, not held."""
    fail_if(failures, not (gc["same_leaves"] and gc["loss_rel_err"] <= TRAIN_LOSS_TOL
                           and gc["zero_grad_leaves_max"] <= TRAIN_ZERO_GRAD_TOL
                           and (key == "grad_check_trained"
                                or gc["grad_rel_err_max"] <= TRAIN_GRAD_TOL)),
            f"train ({run}) {key}: kernel route against plain route {gc}")


def first_batch(trainer):
    """The run's first batch on the card, as its first step saw it."""
    from hig_tpu_torch.data.dataset import epoch_batches

    cfg = trainer.cfg
    model = trainer.init_state().model
    batch = trainer._device_batch(
        next(epoch_batches(trainer_dataset(cfg), TRAIN_PAIRS, 0, seed=cfg.seed)),
        trainer.precompute_tower(model))
    return batch, model


def phase_train(device, failures, smi: str, requests: list, data: str,
                tmp: str) -> tuple[dict, dict, dict]:
    """Drive ``python -m hig_tpu_torch.train``'s main at full width on a
    seeded dataset: PIT through B2, PIT --no_eff through B4, the supervised
    stage; hold one fixed batch's loss and gradients through the kernels
    against the plain route; serve 8 requests from the PIT run's checkpoint.
    Returns the launch counts of the three runs and the serving call,
    {run: (call, wall s or None)} of one more PIT training step and one more
    serving call from the checkpoint (a replay), profiled last, and the PIT
    run's step time, pairs/s and peak memory. Files go under ``tmp``."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import trainer as tr

    kernels = wrappers()
    launches = {name: 0 for name in kernels}
    kept = {}
    for run, (extra, steps, own) in TRAIN_RUNS.items():
        trainer, state, row, counts = (graphed_and_eager_run if run == "pit" else train_run)(
            run, extra, steps, own, data, tmp, failures, smi)
        cfg = trainer.cfg
        if run != "supervised":
            # the run's first batch; the run's initial weights, rebuilt from its seed
            batch, initial = first_batch(trainer)
            row["grad_check"] = grad_route_errors(initial, trainer.sched, batch, pit=True)
            del initial
            row["grad_check"]["tol"] = {"loss_rel": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL,
                                        "zero_grad": TRAIN_ZERO_GRAD_TOL}
            row["grad_check_trained"] = grad_route_errors(state.model, trainer.sched, batch,
                                                          pit=True, float64=True)
        print(json.dumps(row), flush=True)
        for key in ("grad_check", "grad_check_trained"):
            if key in row:
                gate_grad_check(failures, run, key, row[key])
        for name in kernels:
            launches[name] += counts[name]
        if run == "pit":
            kept = {"trainer": trainer, "state": state, "batch": batch, "step_ms": row[
                "median_ms_per_step_after_first"], "pairs_per_s": row["pairs_per_s"],
                "eager_step_ms": row["eager"]["median_ms_per_step_after_first"],
                "max_memory_allocated_gb": row["max_memory_allocated_gb"],
                "model_dir": cfg.model_dir,
                "meta_dir": cfg.meta_dir,
                "model_config": dataclasses.replace(trainer.model_config, fused_blocks=True)}
        del trainer, state

    # serve from the PIT run's checkpoint, through the fused blocks (B1)
    model = serve.build_model(kept["model_config"], device,
                              params=os.path.join(kept["model_dir"], "latest.pt"))
    mean, std = serve.load_stats(kept["meta_dir"], model.cfg.input_feats)
    sample_fn = tr.make_sampler(model, g.make_schedule(g.linear_betas(1000)), T=T,
                                dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS)
    for w in kernels.values():
        w.launches = 0
    gen = torch.Generator(device=device).manual_seed(0)
    features, joints = serve.serve_batch(sample_fn, requests, mean, std, device, gen)
    counts = {name: w.launches for name, w in kernels.items()}
    finite = bool(np.isfinite(features).all() and np.isfinite(joints).all())
    print(json.dumps({"phase": "serve_trained", "checkpoint": "pit/model/latest.pt",
                      "requests": len(requests), "launches": counts, "finite": finite,
                      "joints_shape": list(joints.shape)}), flush=True)
    fail_if(failures, not finite or tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3)
            or counts["fused_block"] != FIRST_CALL,
            f"serving the trained checkpoint: finite {finite}, shape {joints.shape}, {counts}")
    for name in kernels:
        launches[name] += counts[name]
    serve_trained = serve_with(sample_fn, requests, mean, std)

    step_gen = torch.Generator(device=device).manual_seed(9)
    steps = {graph: tr.make_train_step(kept["trainer"].sched, True, graph=graph)
             for graph in (True, False)}

    def one_step(graph=True):
        return {k: float(v) for k, v in steps[graph](kept["state"], kept["batch"],
                                                     step_gen).items()}

    one_step()  # eager, then the capture: the profile traces a replay
    f32_pit = {k: kept[k] for k in ("step_ms", "pairs_per_s", "max_memory_allocated_gb")}
    return launches, {"train_step_pit": (one_step, kept["step_ms"] / 1e3),
                      "train_step_pit_eager": (lambda: one_step(graph=False),
                                               kept["eager_step_ms"] / 1e3),
                      "serve_trained": (seeded(serve_trained), None)}, f32_pit


def phase_pipeline(device, failures, smi: str, requests: list, data: str,
                   tmp: str) -> tuple[dict, dict]:
    """The paper's three stages through the port's entry points on the
    dataset in ``data`` (see the module doc, phase 7). Returns the launch
    counts of every stage and {run: (call, median wall s or None)} of one
    labeling vote and of the guided and caption-id serving calls (replays),
    profiled last."""
    from hig_tpu_torch import label, serve
    from hig_tpu_torch.data.dataset import PairDataset, epoch_batches
    from hig_tpu_torch.data.vocab import CAP2KEY, CLASSID2CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.train import checkpoint as ckpt
    from hig_tpu_torch.train import labeling
    from hig_tpu_torch.train import trainer as tr

    kernels = wrappers()
    launches = {name: 0 for name in kernels}
    sched = g.make_schedule(g.linear_betas(1000))

    def reset():
        for w in kernels.values():
            w.launches = 0
        torch.cuda.synchronize()
        return time.perf_counter()

    def read(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, {name: w.launches for name, w in kernels.items()}

    def add(counts):
        for name in kernels:
            launches[name] += counts[name]

    def only(counts, own, n):
        return all(counts[k] == (n if k == own else 0) for k in kernels)

    # stage 1-1: PIT with caption ids, through B2
    trainer, state, row, counts = train_run("pit_cap_id", *CAP_ID_RUN, data, tmp, failures, smi)
    add(counts)
    batch, initial = first_batch(trainer)
    row["grad_check"] = grad_route_errors(initial, trainer.sched, batch, pit=True)
    del initial, batch
    print(json.dumps({**row, "phase": "pipeline", "stage": "1-1"}), flush=True)
    gate_grad_check(failures, "pit_cap_id", "grad_check", row["grad_check"])
    pit_cfg, pit_model_config = trainer.cfg, trainer.model_config
    del trainer, state

    # stage 1-2: role discovery, then pseudo-labels, through B1
    opt = os.path.join(pit_cfg.save_root, "opt.txt")
    for flag, clips, repeats in (("--label_model", ANN_CLIPS, labeling.DISCOVERY_REPEATS),
                                 ("--save_label", TRAIN_CLIPS, labeling.LABELING_REPEATS)):
        t0 = reset()
        label.main(["--opt_path", opt, flag, "--batch_size", str(LABEL_BATCH)])
        wall, counts = read(t0)
        add(counts)
        forwards = -(-clips // LABEL_BATCH) * len(labeling.LABEL_T_VALUES) * repeats
        print(json.dumps({"phase": "pipeline", "stage": "1-2", "run": flag[2:],
                          "nvidia_smi": smi, "clips": clips, "forwards": forwards,
                          "launches": counts, "wall_s": wall, "forwards_per_s": forwards / wall,
                          "clips_per_s": clips / wall}), flush=True)
        fail_if(failures, not only(counts, "fused_block", LAUNCHES_PER_STEP * forwards),
                f"label {flag}: launches {counts}, expected {LAUNCHES_PER_STEP * forwards} of B1")
    with open(os.path.join(pit_cfg.save_root, "pit_labels.json")) as f:
        roles = json.load(f)
    asymmetric = [c for c, (a, p) in enumerate(CLASSID2CAPS) if a != p]
    roles_ok = len(roles) == len(CLASSID2CAPS) and len(asymmetric) == 17 and all(
        {roles[str(c)].get("active_index"), roles[str(c)].get("passive_index")}
        == {CAP2KEY[CLASSID2CAPS[c][0]], CAP2KEY[CLASSID2CAPS[c][1]]} for c in asymmetric)
    with open(os.path.join(data, "pseudo_labels.json")) as f:
        labels = json.load(f)
    with open(os.path.join(data, "train_sub.txt")) as f:
        train_names = f.read().split()
    labels_ok = set(labels) == set(train_names) and set(labels.values()) <= {0, 1}
    fail_if(failures, not roles_ok, f"pit_labels.json incomplete: {roles}")
    fail_if(failures, not labels_ok, f"pseudo_labels.json incomplete: {labels}")

    # the scorer through B1 against the plain route: one batch, one t
    model = InteractionModel(dataclasses.replace(pit_model_config, fused_blocks=True))
    model.load_state_dict(ckpt.load(os.path.join(pit_cfg.model_dir, "latest.pt"))["params"])
    encode, score = labeling.make_assignment_scorer(model.to(device), sched)
    mean, std = serve.load_stats(pit_cfg.meta_dir, pit_cfg.dim_pose)
    b = next(epoch_batches(PairDataset(pit_cfg, mean, std, "train_sub.txt"), LABEL_BATCH, 0,
                           shuffle=False, drop_last=False))
    cond = torch.from_numpy(b["cap_ids"]).long().to(device)
    motion = torch.from_numpy(b["motion"]).to(device)
    lengths = torch.from_numpy(b["lengths"]).long().to(device)
    noise = torch.randn(motion.shape, generator=torch.Generator(device=device).manual_seed(3),
                        device=device)
    xf_proj, xf_out = encode(cond, cond.flip(1))
    t_vote = labeling.LABEL_T_VALUES[0]
    got = score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)
    with plain_blocks():
        want = score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())

    def vote():
        return score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)

    vote_s = []
    for _ in range(5):
        t0 = reset()
        vote()
        vote_s.append(read(t0)[0])
    differ = got.argmin(dim=1) != want.argmin(dim=1)
    margin = (want[:, 0] - want[:, 1]).abs()
    print(json.dumps({"phase": "pipeline", "stage": "1-2", "run": "scorer_vs_plain",
                      "pairs": LABEL_BATCH, "t": t_vote, "max_abs_err": err, "rel_err": rel,
                      "vote_ms_median": 1e3 * statistics.median(vote_s),
                      "vote_ms": [1e3 * x for x in vote_s],
                      "rel_tol": DENOISER_TOL, "votes_differing": int(differ.sum()),
                      "smallest_margin": float(margin.min()),
                      "largest_margin_of_a_differing_vote": float(margin[differ].max())
                      if differ.any() else None}), flush=True)
    fail_if(failures, not rel <= DENOISER_TOL, f"scorer through B1: rel err {rel}")
    fail_if(failures, bool((differ & (margin > 2 * err)).any()),
            f"scorer through B1: a vote differs with margin above 2 x {err}")

    # stage 1-3: supervised on the pseudo-labels, caption dropout, loss-aware
    # timesteps and a validation pass, through B2
    trainer, state, row, counts = train_run("cfg_supervised", *CFG_RUN, data, tmp, failures, smi,
                                            val_batches=VAL_CLIPS // TRAIN_PAIRS)
    add(counts)
    batch, initial = first_batch(trainer)
    keep = torch.arange(TRAIN_PAIRS, device=device) % 4 != 0  # drops 8 of the 32 pairs
    row["grad_check"] = grad_route_errors(initial, trainer.sched, batch, pit=False, keep=keep)
    del initial, batch
    print(json.dumps({**row, "phase": "pipeline", "stage": "1-3"}), flush=True)
    gate_grad_check(failures, "cfg_supervised", "grad_check", row["grad_check"])
    cfg_dir, cfg_meta, cfg_model_config = (trainer.cfg.model_dir, trainer.cfg.meta_dir,
                                           trainer.model_config)
    del trainer, state

    # guided serving from stage 1-3's checkpoint, through B1
    model = serve.build_model(dataclasses.replace(cfg_model_config, fused_blocks=True), device,
                              params=os.path.join(cfg_dir, "latest.pt"))
    mean, std = serve.load_stats(cfg_meta, model.cfg.input_feats)
    kw = dict(T=T, dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS,
              guidance_scale=GUIDANCE)
    sample_fn = tr.make_sampler(model, sched, **kw)
    guided = serve_with(sample_fn, requests, mean, std)
    eager = serve_with(tr.make_sampler(model, sched, graph=False, **kw), requests, mean, std)
    row, (features, joints), first, call_counts = graph_and_eager(
        "guided serving", guided, eager, sample_fn.graphs, failures)
    with plain_blocks():
        ref_features, _ = eager(torch.Generator(device=device).manual_seed(0))
    rel = float(np.abs(features - ref_features).max() / np.abs(ref_features).max())
    finite = bool(np.isfinite(features).all() and np.isfinite(joints).all())
    wall = row["wall_s_per_call"]
    add(call_counts[0])
    print(json.dumps({"phase": "pipeline", "stage": "serve_guided", "nvidia_smi": smi,
                      "guidance_scale": GUIDANCE, "requests": len(requests),
                      "ddim_steps": DDIM_STEPS, "launches": call_counts[0], **row,
                      "finite": finite, "joints_shape": list(joints.shape),
                      "rel_err_vs_plain": rel, "rel_tol": GUIDED_REL_TOL,
                      "rel_err_over_sampler_tol": rel / SAMPLER_REL_TOL}), flush=True)
    fail_if(failures, not all(only(c, "fused_block", LAUNCHES_PER_CALL) for c in call_counts)
            or not only(first, "fused_block", FIRST_CALL),
            f"guided serving launches {first}, {call_counts}")
    fail_if(failures, not finite or tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3),
            f"guided serving: finite {finite}, shape {joints.shape}")
    fail_if(failures, not rel <= GUIDED_REL_TOL, f"guided serving rel err {rel}")

    # serving stage 1-1's caption-id checkpoint, w = 1, through B1
    model = serve.build_model(dataclasses.replace(pit_model_config, fused_blocks=True), device,
                              params=os.path.join(pit_cfg.model_dir, "latest.pt"))
    mean, std = serve.load_stats(pit_cfg.meta_dir, model.cfg.input_feats)
    cap_sample = tr.make_sampler(model, sched, T=T, dim_pose=model.cfg.input_feats,
                                 ddim_steps=DDIM_STEPS)
    t0 = reset()
    features, joints = serve.serve_batch(cap_sample, requests, mean, std, device,
                                         torch.Generator(device=device).manual_seed(0),
                                         cap_id=True)
    cap_wall, counts = read(t0)
    add(counts)
    finite = bool(np.isfinite(features).all() and np.isfinite(joints).all())
    print(json.dumps({"phase": "pipeline", "stage": "serve_cap_id", "requests": len(requests),
                      "launches": counts, "wall_s": cap_wall, "finite": finite,
                      "joints_shape": list(joints.shape)}), flush=True)
    fail_if(failures, not finite or tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3)
            or not only(counts, "fused_block", FIRST_CALL),
            f"serving the caption-id checkpoint: finite {finite}, shape {joints.shape}, {counts}")
    cap_id = serve_with(cap_sample, requests, mean, std, cap_id=True)
    return launches, {"label_vote": (vote, statistics.median(vote_s)),
                      "serve_guided": (seeded(guided), wall),
                      "serve_cap_id": (seeded(cap_id), None)}


def eval_train_run(kind: str, data: str, tmp: str, failures, smi: str) -> tuple[dict, dict]:
    """``python -m hig_tpu_torch.eval.train``'s main for one evaluator at
    full width (8 layers, latent 512, FFN 1024, 8 heads), batch 32, two
    epochs; its launch counts (none of any kernel: the evaluators are plain
    PyTorch), finite losses, the checkpoint, ms per step, peak memory, and
    one validation batch's logits on the card against the same model on the
    CPU. Returns (the printed row, the counts)."""
    from hig_tpu_torch.data.dataset import PairDataset, epoch_batches
    from hig_tpu_torch.eval.trainer import BEST, logits_of
    from hig_tpu_torch.eval.train import main as eval_train_main
    from hig_tpu_torch.serve import load_stats

    kernels = wrappers()
    name = "eval_model" if kind == "classifier" else "consistency_eval_model"
    for w in kernels.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, model, best_acc, history = eval_train_main([
        "--kind", kind, "--name", name, "--data_root", data,
        "--checkpoints_dir", os.path.join(tmp, "runs"), "--batch_size", str(TRAIN_PAIRS),
        "--num_epochs", "3", "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.cfg
    mean, std = load_stats(cfg.meta_dir, cfg.dim_pose)
    batch = next(epoch_batches(PairDataset(cfg, mean, std, "val_sub.txt", train_eval=True),
                               TRAIN_PAIRS, 0, shuffle=False, drop_last=False))
    motion = torch.from_numpy(batch["motion"][..., :-4].copy())
    lengths = torch.from_numpy(batch["lengths"]).long()
    model.eval()
    with torch.no_grad():
        got = logits_of(model, motion.to("cuda"), lengths.to("cuda")).cpu()
        want = logits_of(copy.deepcopy(model).cpu(), motion, lengths)
    rel = float((got - want).abs().max() / want.abs().max())
    step_ms = [1e3 * s for s in trainer.step_seconds]
    losses = [h["train_loss"] for h in history]
    row = {"phase": "evaluate", "run": f"eval_train_{kind}", "nvidia_smi": smi,
           "pairs_per_step": TRAIN_PAIRS, "epochs": len(history), "steps": len(step_ms),
           "launches": counts, "step_ms": step_ms, "train_losses": losses,
           "val_accs": [h["val_acc"] for h in history], "best_val_acc": best_acc,
           "max_memory_allocated_gb": peak / 1e9, "wall_s": wall,
           "params": sum(p.numel() for p in model.parameters()),
           "logits_rel_err_card_vs_cpu": rel, "rel_tol": EVAL_LOGITS_REL_TOL}
    print(json.dumps(row), flush=True)
    fail_if(failures, any(counts.values()), f"eval.train {kind}: launches {counts}")
    fail_if(failures, len(history) != 2 or len(step_ms) != 2 or not np.isfinite(losses).all(),
            f"eval.train {kind}: history {history}")
    fail_if(failures, not os.path.exists(os.path.join(cfg.model_dir, BEST)),
            f"eval.train {kind}: no {BEST}")
    fail_if(failures, not rel <= EVAL_LOGITS_REL_TOL,
            f"eval.train {kind}: logits on the card vs the CPU rel err {rel}")
    return row, counts


@contextlib.contextmanager
def spy_samplers(module):
    """Every sampler that ``module.make_sampler`` makes while in the block,
    as (sampler, the arguments it was made with, its first call's (cond,
    lengths, generator state)), the last filled in at that call."""
    real, made = module.make_sampler, []

    def spy(*args, **kwargs):
        fn, first = real(*args, **kwargs), []

        def recording(cond, lengths, generator=None, **kw):
            if not first:
                first.append((cond.clone(), lengths.clone(), generator.get_state()))
            return fn(cond, lengths, generator=generator, **kw)

        recording.graphs = fn.graphs
        made.append((fn, args, kwargs, first))
        return recording

    module.make_sampler = spy
    try:
        yield made
    finally:
        module.make_sampler = real


def first_chunk(made):
    """``call()``: a recorded sampler's first chunk again (see
    ``spy_samplers``), from the chunk's generator state."""
    fn, _, _, ((cond, lengths, state),) = made

    def call():
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        return fn(cond, lengths, generator=gen)

    return call


def chunk_graph_and_eager(label: str, made, failures) -> dict:
    """A recorded sampler's first chunk again (see ``spy_samplers``): one
    replay of its graph and one call of the same model's eager loop
    (``graph=False``), each from the chunk's generator state, timed; the
    outputs must be equal bit for bit."""
    from hig_tpu_torch.train.trainer import make_sampler

    fn, args, kwargs, ((cond, lengths, state),) = made
    eager = make_sampler(*args, **{**kwargs, "graph": False})
    row, outs = {}, []
    for name, sample in (("replay", fn), ("eager", eager)):
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sample(cond, lengths, generator=gen).cpu())
        torch.cuda.synchronize()
        row[f"{name}_wall_s"] = time.perf_counter() - t0
        row[f"{name}_launches"] = {k: v for k, v in bf16_counts().items() if v}
    row["graph_equals_eager"] = bool(torch.equal(*outs))
    fail_if(failures, not row["graph_equals_eager"]
            or row["replay_launches"] != row["eager_launches"],
            f"{label}: the first chunk's replay against the eager loop: {row}")
    return row


def phase_evaluate(device, failures, smi: str, data: str, tmp: str,
                   model) -> tuple[dict, dict]:
    """Phase 9 (see the module doc): both evaluator trainings, the three
    ``python -m hig_tpu_torch.evaluate`` runs from stage 1-3's checkpoint
    (the first chunk of DDIM-50 guided and of DPM-20 again through the
    graph and through the eager loop), and DDPM-1000 through B1, graphed
    against the eager loop, and DDPM over DDPM_PLAIN_STEPS steps against the
    plain route, on ``model`` (the flagship with fused blocks) at the
    serving shape. Returns the launch
    counts and, for the profile, {run: (call, replayed wall s or None)}:
    each evaluate run's first chunk ("evaluate_<run>"; its DDPM-1000 one
    is the profile's DDPM trace)."""
    from hig_tpu_torch import evaluate, serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import trainer as tr

    kernels = wrappers()
    launches = {name: 0 for name in kernels}
    for kind in ("classifier", "consistency"):
        for name, n in eval_train_run(kind, data, tmp, failures, smi)[1].items():
            launches[name] += n

    # stage 1-3 trained on 32 clips (--limit_data_num 32), which evaluation
    # would apply to the test split too: evaluate its checkpoint on all of it
    with open(os.path.join(tmp, "runs", "ntu_mul", "cfg_supervised", "opt.txt")) as f:
        text = f.read()
    opt = os.path.join(tmp, "cfg_supervised_eval_opt.txt")
    with open(opt, "w") as f:
        f.write(text.replace("limit_data_num: 32\n", "limit_data_num: -1\n"))
    fail_if(failures, "limit_data_num: 32\n" not in text, "stage 1-3's opt.txt: no limit line")
    ddpm_grid_bytes = 1000 * 2 * EVAL_CLIPS * 8 * 4 * 2 * D * 4  # steps × seqs × blocks × 2D
    runs = {}
    for run, (extra, calls, reps) in EVAL_RUNS.items():
        for w in kernels.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with spy_samplers(evaluate) as made:
            out = evaluate.main(["--opt_path", opt, "--mm_num_times", "1", "--file_id", run,
                                 *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: w.launches for name, w in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        graph_row = (None if run == "ddpm1000" else
                     chunk_graph_and_eager(f"evaluate {run}", made[0], failures))
        runs[f"evaluate_{run}"] = (first_chunk(made[0]),
                                   graph_row and graph_row["replay_wall_s"])
        with open(os.path.join(out["save_dir"], f"summary{run}.json")) as f:
            summary = json.load(f)
        cms = [np.load(os.path.join(out["save_dir"], f"confusion_matrix{run}_rep{r}.npy"))
               for r in range(reps)]
        values = [v for models in summary.values() for mv in models.values() for v in mv]
        means = {m: {k: v[0] for k, v in summary.get(m, {}).items()} for m in METRICS}
        # one chunk of EVAL_CLIPS pairs, and one warm-up denoiser call a capture
        want = LAUNCHES_PER_STEP * (calls * reps + len(out["graphs"]))
        print(json.dumps({
            "phase": "evaluate", "run": run, "nvidia_smi": smi, "args": extra,
            "test_clips": EVAL_CLIPS, "launches": counts, "expected_b1": want,
            "wall_s": wall, "wall_s_per_replication": wall / reps,
            "max_memory_allocated_gb": peak / 1e9, "graphs": list(out["graphs"].values()),
            "first_chunk_graph_vs_eager": graph_row, "summary": summary,
            "confusion_sums": [int(cm.sum()) for cm in cms]}), flush=True)
        fail_if(failures, any(counts[n] != (want if n == "fused_block" else 0) for n in kernels),
                f"evaluate {run}: launches {counts}, expected {want} of B1")
        fail_if(failures, list(summary) != list(METRICS) or any(
            set(models) != {"ground truth", "text2motion"} for models in summary.values()),
            f"evaluate {run}: summary {summary}")
        fail_if(failures, not np.isfinite(values).all(), f"evaluate {run}: non-finite metric")
        fail_if(failures, not all(0.0 <= v <= 1.0 for m in ("Acc", "Consistency")
                                  for v in means[m].values()),
                f"evaluate {run}: Acc / Consistency outside [0, 1]: {means}")
        fail_if(failures, not all(v >= 0.0 for v in means["FID"].values()),
                f"evaluate {run}: negative FID {means['FID']}")
        fail_if(failures, any(int(cm.sum()) != EVAL_CLIPS for cm in cms),
                f"evaluate {run}: confusion sums {[int(cm.sum()) for cm in cms]}")
        if run == "ddpm1000":
            fail_if(failures, not peak < ddpm_grid_bytes,
                    f"evaluate {run}: peak {peak} B, not below the AdaLN grid's "
                    f"{ddpm_grid_bytes} B")
        for name in kernels:
            launches[name] += counts[name]

    # DDPM-1000 through B1: 8 requests, graphed against the eager loop
    requests = serve_requests()
    mean, std = serve.load_stats(None, model.cfg.input_feats)
    kw = dict(T=T, dim_pose=model.cfg.input_feats, sampler="ddpm")
    sched = g.make_schedule(g.linear_betas(1000))
    sample_fn = tr.make_sampler(model, sched, **kw)
    ddpm = serve_with(sample_fn, requests, mean, std)
    eager = serve_with(tr.make_sampler(model, sched, graph=False, **kw), requests, mean, std)
    # the capture, one replay, one eager call (the same x_T and step noises
    # from one generator seed, which must end in the same state)
    row, (features, joints), first, (counts,) = graph_and_eager(
        "DDPM-1000", ddpm, eager, sample_fn.graphs, failures, replays=1, eager_calls=1)
    # the kernels against the plain route, the eager loop of a DDPM call of
    # DDPM_PLAIN_STEPS steps (the same x_T and step noises): the depth cut
    short = serve_with(tr.make_sampler(model, g.make_schedule(g.linear_betas(DDPM_PLAIN_STEPS)),
                                       graph=False, **kw), requests, mean, std)
    kernel_features, _ = short(torch.Generator(device=device).manual_seed(0))
    with plain_blocks():
        t1 = time.perf_counter()
        ref_features, _ = short(torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t1
    rel = float(np.abs(kernel_features - ref_features).max() / np.abs(ref_features).max())
    finite = bool(np.isfinite(features).all() and np.isfinite(joints).all())
    print(json.dumps({"phase": "evaluate", "run": "serve_ddpm1000_vs_plain", "nvidia_smi": smi,
                      "requests": len(requests), "T": T, "steps": 1000, "launches": counts,
                      **row, "plain_steps": DDPM_PLAIN_STEPS,
                      "plain_wall_s_per_call": plain_wall,
                      "finite": finite, "joints_shape": list(joints.shape),
                      "max_abs_features": float(np.abs(ref_features).max()),
                      "rel_err_vs_plain": rel, "rel_tol": SAMPLER_REL_TOL}), flush=True)
    fail_if(failures, any(counts[n] != (LAUNCHES_PER_STEP * 1000 if n == "fused_block" else 0)
                          for n in kernels)
            or any(first[n] != (LAUNCHES_PER_STEP * 1001 if n == "fused_block" else 0)
                   for n in kernels), f"DDPM-1000 launches {first}, {counts}")
    fail_if(failures, not finite or tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3),
            f"DDPM-1000: finite {finite}, shape {joints.shape}")
    fail_if(failures, not rel <= SAMPLER_REL_TOL, f"DDPM-{DDPM_PLAIN_STEPS} rel err {rel}")
    for name in kernels:
        launches[name] += counts[name]
    return launches, runs


# --- phase 10: bfloat16 ----------------------------------------------------------------

# bfloat16 form → the wrapper whose ``launches_bf16`` counts it
BF16_FORMS = {"fused_block_bf16": "fused_block",
              "projected_attention_bf16": "projected_attention",
              "efficient_attention_bf16": "efficient_attention",
              "flash_attention_bf16": "flash_attention"}
# serving run (a model of ``bf16_models``) → (the form its attention blocks
# launch, guidance weight)
BF16_SERVE_RUNS = {
    "fused": ("fused_block_bf16", 1.0),
    "projected": ("projected_attention_bf16", 1.0),
    "no_eff": ("flash_attention_bf16", 1.0),
    "rms_norm": ("projected_attention_bf16", 1.0),
    "guided": ("fused_block_bf16", GUIDANCE),
}
BF16_EVAL_RUN = ["--sampler", "dpm", "--ddim_steps", "20", "--fast_ln"]
BF16_EVAL_LAUNCHES = LAUNCHES_PER_STEP * 20  # one chunk of EVAL_CLIPS pairs, DPM-20
# Kernel against its bfloat16 twin: both form the same exact products of
# bfloat16 values and differ in the order of float32 sums, so a rounding
# comes out otherwise only where a value lies within ~1e-7 of a rounding
# boundary. max |kernel − twin| ≤ BF16_ULPS bfloat16 ulps of max |twin|,
# and rms(kernel − twin) ≤ BF16_KERNEL_RMS · rms(twin − float32 twin), the
# float32 twin taken on the same bfloat16-rounded inputs and weights and not
# rounded: a form that skipped one of the Pallas kernel's roundings would
# sit near the bfloat16 effect itself. Where the order of float32 sums alone
# moves more roundings than that, the bound is BF16_FLOOR times the twin's
# own distance from the same twin run on the CPU (the same roundings, sums in
# another order): B1's KᵀV state is a sum of ~91 terms of either sign that
# cancels, so its float32 order flips some of its bfloat16 roundings, and
# its second LayerNorm spreads each flip over y.
BF16_ULP, BF16_ULPS, BF16_KERNEL_RMS, BF16_FLOOR = 2.0 ** -8, 2.0, 0.25, 1.5
# B1's core roundings that a planted control leaves out, one at a time: the
# twin without it, put in the kernel's place, must fail the gates above.
B1_CORE_ROUNDINGS = ("kh", "v", "att", "qh")
# B3-bf16's rounding points (its Pallas kernel's softmaxes run on bfloat16
# values, so each of their ops rounds); the twin without any one of them,
# put in the kernel's place, must fail the gates too. B2-bf16's core is
# float32: its twin with B1's core roundings must fail its gates.
B3_CORE_ROUNDINGS = ("q_sub", "q_exp", "q_sum", "qh", "k_sub", "k_exp", "k_sum", "kh", "att")
# Denoiser and serving through the kernels against the plain route in
# bfloat16, held to rms(kernel − plain bf16) ≤ BF16_ROUTE_RMS ·
# rms(plain bf16 − plain float32) on the same inputs and weights. One
# bfloat16 rounding that comes out otherwise moves later roundings of its
# sequence, and each block carries the move on: through 8 layers the plain
# route itself, one input element a pair moved by one bfloat16 ulp, lands
# near the bfloat16 effect, and so does any route that sums in another
# order (reported, not held). So the denoiser is held at its first layer
# (full width, the same weights), where a route that rounds as the Pallas
# kernels do sits below the limit and the control route (each kernel
# replaced by its float32 plain version on the upcast inputs, output
# rounded: the kernels' own roundings left out) above it; a control that
# passes fails the run (PERF.md §6 has the readings). B2's Pallas kernel
# rounds only its output, so its control is the same function and is
# reported only. Serving (DDIM-50, full depth) is held to the same limit,
# its control reported: there the control reads as the kernel route does,
# so that gate bounds the drift and proves no rounding point.
BF16_ROUTE_RMS = 0.7
BF16_DENOISER_RUNS = {"fused": "fused_block_bf16", "projected": "projected_attention_bf16",
                      "no_eff": "flash_attention_bf16", "fast_ln": "fused_block_bf16",
                      "rms_norm": "projected_attention_bf16"}
FORMS_WITH_INNER_ROUNDINGS = ("fused_block_bf16", "flash_attention_bf16")
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)
# B2 on bfloat16 activations with float32 weights, counted in the wrapper's
# ``launches_mixed``. The card's fastest float32-accurate product of a
# bfloat16 activation and a float32 weight splits the weight into three
# bfloat16 pieces (8 + 8 + 8 significand bits, each product exact in
# float32): three bf16 products at 989 TFLOP/s, as the kernel takes them.
MIXED_FORM = "projected_attention_bf16a"
# B3-bf16's lazy forms (LAZY_KNORM), counted in ``launches_bf16_lazy``
LAZY_FORM = "efficient_attention_bf16_lazy"
BF16_SPLIT = 3
# The ordered bfloat16 sum of the bfloat16 backwards (``ops/bf16_sum.py``),
# counted in ``bf16_sum.launches``: launched by every bfloat16 train step
# (B3-bf16's and B4-bf16's backwards, the model's bfloat16 softmaxes).
BF16_SUM = "bf16_sum"


def bound_parts(parts, nbytes: float) -> tuple[float, str, str]:
    """The card's least time for work in ``parts``, [(flops, rate)], each
    part at its own rate ("bf16": 989 TFLOP/s; "3xtf32": a float32-accurate
    product, 495 / 3; "3xbf16": a float32-accurate product of a bfloat16
    value and a float32 one, 989 / 3; "f32": float32 adds without the
    tensor cores, 67 T/s), against ``nbytes`` at 3.35 TB/s. Returns (ms,
    "operations" or "bytes", the kind)."""
    rates = {"bf16": PEAK_BF16_FLOPS, "3xtf32": PEAK_TF32_FLOPS / TF32_SPLIT,
             "3xbf16": PEAK_BF16_FLOPS / BF16_SPLIT, "f32": PEAK_F32_FLOPS}
    t_ops = sum(flops / rates[rate] for flops, rate in parts)
    t_bytes = nbytes / PEAK_BYTES
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "bytes"
    return t_ops * 1e3, "operations", "ops_" + "+".join(sorted({r for _, r in parts}))


def bf16_counts() -> dict:
    """Launch counts of every form: the float32 kernels', the bfloat16
    forms' and B2-bf16a's."""
    kernels = wrappers()
    counts = {name: w.launches for name, w in kernels.items()}
    counts.update({form: kernels[base].launches_bf16 for form, base in BF16_FORMS.items()})
    counts[MIXED_FORM] = kernels["projected_attention"].launches_mixed
    counts[LAZY_FORM] = kernels["efficient_attention"].launches_bf16_lazy
    return counts


def reset_counts() -> None:
    from hig_tpu_torch.ops.bf16_sum import bf16_sum

    for w in (*wrappers().values(), bf16_sum):
        for attr in ("launches", "launches_bf16", "launches_mixed", "launches_bf16_lazy"):
            if hasattr(w, attr):
                setattr(w, attr, 0)


def on_cpu(args):
    """The arguments of a plain version, tensors (and BlockWeights) on the CPU."""
    from hig_tpu_torch.ops.fused_block import BlockWeights

    def move(a):
        if isinstance(a, BlockWeights):
            return BlockWeights(*[t.cpu() for t in a])
        return a.cpu() if torch.is_tensor(a) else a

    return [move(a) for a in args]


def bf16_gate_row(got, twin, twin_f32, twin_cpu) -> dict:
    """The kernel-against-twin gates (see BF16_KERNEL_RMS and BF16_FLOOR):
    the readings, and under "passed" whether ``got`` meets them."""
    def rms(d):
        return d.pow(2).mean().sqrt().item()

    d = got.float() - twin.float()
    max_abs = d.abs().max().item()
    lim = BF16_ULPS * BF16_ULP * twin.float().abs().max().item()
    err, ref = rms(d), rms(twin.float() - twin_f32)
    floor = rms(twin.float().cpu() - twin_cpu.float())
    rms_lim = max(BF16_KERNEL_RMS * ref, BF16_FLOOR * floor)
    return {"max_abs_err": max_abs, "max_abs_lim": lim, "rms_err": err,
            "rms_twin_vs_f32": ref, "rms_ratio": err / ref if ref else None,
            "rms_ratio_lim": BF16_KERNEL_RMS, "rms_twin_vs_cpu_twin": floor,
            "rms_floor_ratio": floor / ref if ref else None, "rms_lim": rms_lim,
            "passed": bool(got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
                           and max_abs <= lim and err <= rms_lim)}


def gate_bf16(label: str, got, twin, twin_f32, twin_cpu, failures) -> dict:
    row = bf16_gate_row(got, twin, twin_f32, twin_cpu)
    fail_if(failures, not row.pop("passed"), f"{label}: {row}")
    return row


def to_bf16(t):
    return t.to(torch.bfloat16)


def check_fused_block_bf16(w, x, mask, scale, shift, failures) -> dict:
    """B1-bf16, self-attention and interaction, against its twin."""
    from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block
    from hig_tpu_torch.ops.fused_block import fused_attention_block_plain as plain

    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    M = N * Tq
    wb = BlockWeights(*[to_bf16(t) for t in w])
    w32 = BlockWeights(*[t.float() for t in wb])
    xb, sb, shb = to_bf16(x), to_bf16(scale), to_bf16(shift)
    cases = {}
    for interaction in (False, True):
        args = (xb, mask, sb, shb, wb, HEADS, interaction)
        got = fused_attention_block(*args)
        twin = plain(*args)
        twin32 = plain(xb.float(), mask, sb.float(), shb.float(), w32, HEADS, interaction)
        twin_cpu = plain(*on_cpu(args))
        torch.cuda.synchronize()
        name = "interaction" if interaction else "self"
        label = f"fused_block_bf16 {name} {N}x{Tq}"
        cases[name] = gate_bf16(label, got, twin, twin32, twin_cpu, failures)
        controls = {}
        for left_out in B1_CORE_ROUNDINGS:
            row = bf16_gate_row(plain(*args, unrounded=(left_out,)), twin, twin32, twin_cpu)
            fail_if(failures, row["passed"],
                    f"{label}: the twin without the {left_out} rounding passes: {row}")
            controls[left_out] = row["rms_ratio"]
        cases[name]["controls_rms_ratio"] = controls
        cases[name]["ms"] = time_ms(lambda: fused_attention_block(*args))
        cases[name]["plain_ms"] = time_ms(lambda: plain(*args))
        cases[name]["launch_ms"] = b1_bf16_launch_ms(*args)
    parts = [(2 * M * D * 3 * D + 2 * M * D * D, "bf16"),
             (2 * 2 * N * HEADS * Tq * hd * hd, "bf16")]
    nbytes = 2 * (2 * M * D + 2 * N * D + 4 * D * D + 8 * D) + 4 * M
    return bf16_row("fused_block_bf16", "hig_tpu_torch/csrc/fused_block.cu",
                    "hig_tpu/ops/fused_block.py:48", [N, Tq, D, HEADS], cases, parts, nbytes)


B1_BF16_LAUNCHES = ("row_pass", "qkv_core", "gate_row_pass", "wo_gemm")


def b1_bf16_launch_ms(x, mask, scale, shift, w, heads, interaction) -> dict:
    """B1-bf16's time per launch (``B1_BF16_LAUNCHES``, in order), each timed
    alone as ``time_ms`` times a kernel, on buffers that one whole block has
    filled (the q|k|v + core launch then reads z where it would read xn:
    the same shapes and work)."""
    from hig_tpu_torch.ops.fused_block import launch_bf16

    lead, (Tq, Dm) = x.shape[:-2], x.shape[-2:]
    N = x.numel() // (Tq * Dm)
    m = mask.to(torch.float32).expand(*lead, Tq).reshape(N, Tq).contiguous()
    sc = scale.expand(*lead, 1, Dm).reshape(N, Dm).contiguous()
    sh = shift.expand(*lead, 1, Dm).reshape(N, Dm).contiguous()
    xz = torch.empty((N * Tq, Dm), device=x.device, dtype=torch.bfloat16)
    y = torch.empty((N * Tq, Dm), device=x.device, dtype=torch.float32)
    tensors = (x, m, sc, sh, *w, xz, y, torch.empty_like(x))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    launch_bf16(tensors, N, Tq, Dm, interaction, stream())
    return {name: time_ms(lambda: launch_bf16(tensors, N, Tq, Dm, interaction, stream(), part))
            for part, name in enumerate(B1_BF16_LAUNCHES)}


def bf16_row(name, source, replaces, shape, cases, parts, nbytes, library=None) -> dict:
    """Print the kernel's line and return its row: the slower case's time."""
    b_ms, b_by, b_kind = bound_parts(parts, nbytes)
    print(json.dumps({"phase": "kernel_bf16", "kernel": name, "shape": shape, "cases": cases,
                      "gflop": sum(f for f, _ in parts) / 1e9, "mbytes": nbytes / 1e6,
                      "bound_us": b_ms * 1e3, "bound_by": b_by, "bound_kind": b_kind,
                      **(library or {})}), flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "rms_ratio": max(c["rms_ratio"] for c in cases.values()),
            "ms": max(c["ms"] for c in cases.values()),
            "plain_ms": max(c["plain_ms"] for c in cases.values()),
            "bound_ms": b_ms, "bound_by": b_by, "bound_kind": b_kind,
            "library_ms": (library or {}).get("library_ms")}


def check_projected_attention_bf16(w, x, mask, failures) -> dict:
    """B2-bf16 as the self-attention block calls it (kv_src is q_src) and as
    the interaction block does (kv from the partner), against its twin,
    beside the planted control (the twin with B1-bf16's core roundings)."""
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain

    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    M = N * Tq
    xn = to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    ws = [to_bf16(t) for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    cases = {}
    for name, kv, kmask in (("self", xn, mask),
                            ("partner", xn.flip(1).contiguous(), mask.flip(1).contiguous())):
        args = (xn, kv, *ws, HEADS, kmask)
        got = fused_projected_attention(*args)
        twin = plain(*args)
        twin32 = plain(xn.float(), kv.float(), *[t.float() for t in ws], HEADS, kmask)
        twin_cpu = plain(*on_cpu(args))
        torch.cuda.synchronize()
        label = f"projected_attention_bf16 {name} {N}x{Tq}"
        cases[name] = gate_bf16(label, got, twin, twin32, twin_cpu, failures)
        row = bf16_gate_row(plain(*args, rounded=B1_CORE_ROUNDINGS), twin, twin32, twin_cpu)
        fail_if(failures, row["passed"],
                f"{label}: the twin with B1's core roundings passes: {row}")
        cases[name]["control_rms_ratio"] = row["rms_ratio"]
        cases[name]["ms"] = time_ms(lambda: fused_projected_attention(*args))
        cases[name]["plain_ms"] = time_ms(lambda: plain(*args))
    parts = [(2 * M * D * 3 * D, "bf16"), (2 * 2 * N * HEADS * Tq * hd * hd, "3xtf32")]
    nbytes = 2 * (3 * M * D + 3 * D * D + 3 * D) + 4 * M
    return bf16_row("projected_attention_bf16", "hig_tpu_torch/csrc/projected_attention.cu",
                    "hig_tpu/ops/pallas_attention.py:116", [N, Tq, D, HEADS], cases, parts,
                    nbytes)


def check_projected_attention_bf16a(w, x, mask, failures) -> dict:
    """B2-bf16a (bfloat16 activations, float32 weights) self and partner, as
    a bfloat16 model's unfused blocks call it in eval mode on float32
    master weights, against its twin, beside the planted control (the twin
    with B1-bf16's core roundings: its core must be float32); its weight
    split (the first of its two launches) against the plain split on the
    card, bit for bit, and timed alone (``split_ms``, part of ``ms``)."""
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain
    from hig_tpu_torch.ops.pallas_attention import split_bf16_pieces, weight_pieces

    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    M = N * Tq
    xn = to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    ws = (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)
    cases = {}
    with torch.no_grad():
        for name, kv, kmask in (("self", xn, mask),
                                ("partner", xn.flip(1).contiguous(), mask.flip(1).contiguous())):
            args = (xn, kv, *ws, HEADS, kmask)
            got = fused_projected_attention(*args)
            twin = plain(*args)
            twin32 = plain(xn.float(), kv.float(), *ws, HEADS, kmask)
            twin_cpu = plain(*on_cpu(args))
            torch.cuda.synchronize()
            label = f"{MIXED_FORM} {name} {N}x{Tq}"
            cases[name] = gate_bf16(label, got, twin, twin32, twin_cpu, failures)
            row = bf16_gate_row(plain(*args, rounded=B1_CORE_ROUNDINGS), twin, twin32, twin_cpu)
            fail_if(failures, row["passed"],
                    f"{label}: the twin with B1's core roundings passes: {row}")
            cases[name]["control_rms_ratio"] = row["rms_ratio"]
            cases[name]["ms"] = time_ms(lambda: fused_projected_attention(*args))
            cases[name]["plain_ms"] = time_ms(lambda: plain(*args))
        pieces = weight_pieces(w.wq, w.wk, w.wv)
        want = torch.stack([torch.cat(p) for p in
                            zip(*(split_bf16_pieces(t) for t in (w.wq, w.wk, w.wv)))])
        split_equal = bool(torch.equal(pieces.view(torch.int16), want.view(torch.int16)))
        fail_if(failures, not split_equal,
                f"{MIXED_FORM} {N}x{Tq}: the weight split kernel differs from its plain version")
        split_ms = time_ms(lambda: weight_pieces(w.wq, w.wk, w.wv))
        for case in cases.values():
            case["split_ms"], case["split_bit_for_bit"] = split_ms, split_equal
    parts = [(2 * M * D * 3 * D, "3xbf16"), (2 * 2 * N * HEADS * Tq * hd * hd, "3xtf32")]
    nbytes = 2 * M * D * 2 + 4 * (3 * D * D + 3 * D) + 4 * M  # x, y; weights, biases; mask
    row = bf16_row(MIXED_FORM, "hig_tpu_torch/csrc/projected_attention.cu",
                   "hig_tpu/ops/pallas_attention.py:116", [N, Tq, D, HEADS], cases, parts,
                   nbytes)
    row["split_ms"] = max(c["split_ms"] for c in cases.values())
    return row


def check_b3_bf16_backward(w, x, mask) -> dict:
    """B3-bf16 under autograd at ``x``'s shape, as a bfloat16 model's
    efficient blocks call it in train mode: its backward (XLA's bfloat16 VJP
    of the core, written out) on the card against the same backward on the
    CPU, with the backward's time."""
    from hig_tpu_torch.ops.pallas_attention import efficient_attention_backward
    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention

    q, k, v, heads, m = b3_bf16_inputs(w, x, mask, x.shape[2])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fused_efficient_attention(*leaves, heads, m)
    g = to_bf16(torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
                .to(out.device))
    got = torch.autograd.grad(out, leaves, g)
    mask_full = m.float().expand(*q.shape[:-1]).contiguous()
    want = efficient_attention_backward((q.cpu(), k.cpu(), v.cpu(), mask_full.cpu()), g.cpu(),
                                        heads)
    errs = [(a.float().cpu() - b.float()).abs().max().item() / b.float().abs().max().item()
            for a, b in zip(got, want)]
    ms = time_ms(lambda: efficient_attention_backward((q, k, v, mask_full), g, heads))
    return {"shape": list(q.shape), "max_rel_err_vs_cpu": max(errs),
            "rel_err_lim": BF16_ULP, "backward_ms": ms,
            "passed": all(a.dtype == torch.bfloat16 for a in got) and max(errs) <= BF16_ULP}


def check_bf16_sum(device, failures) -> dict:
    """The ordered bfloat16 sum (``ops/bf16_sum.py``) at the training shape
    (a PIT step's 32 pairs under both assignments, T = 91, 8 heads of 64)
    over the axes the bfloat16 backwards sum: B3-bf16's feature softmax
    (64 terms, contiguous), its time softmax (91 terms, 512 apart) and
    B4-bf16's key softmax (91 terms, 8 apart), against its plain version on
    the card, bit for bit. The row is one B3-bf16 backward's two sums."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum, bf16_sum_plain

    pairs = 2 * TRAIN_PAIRS
    shapes = {"b3_features": ((pairs, 2, T, HEADS, D // HEADS), -1),
              "b3_time": ((pairs, 2, T, HEADS, D // HEADS), -3),
              "b4_keys": ((pairs, 2, T, T, HEADS), -2)}
    gen = torch.Generator().manual_seed(6)
    cases = {}
    for name, (shape, dim) in shapes.items():
        x = to_bf16(torch.randn(shape, generator=gen) * 1e-2).float().to(device)
        got, want = bf16_sum(x, dim), bf16_sum_plain(x, dim)
        err = (got - want).abs().max().item()
        fail_if(failures, err != 0 or got.shape != want.shape,
                f"bf16_sum {name} {list(shape)} over {dim}: max |kernel - plain| {err}")
        ms_bound, by, _ = bound_parts([(x.numel(), "f32")], 4 * (x.numel() + got.numel()))
        cases[name] = {"shape": list(shape), "dim": dim, "max_abs_err": err,
                       "ms": time_ms(lambda: bf16_sum(x, dim)),
                       "plain_ms": time_ms(lambda: bf16_sum_plain(x, dim)),
                       "bound_ms": ms_bound, "bound_by": by}
    print(json.dumps({"phase": "kernel_bf16", "kernel": BF16_SUM, "cases": cases}), flush=True)
    pair = [cases["b3_features"], cases["b3_time"]]
    b_ms, b_by, b_kind = bound_parts(
        [(2 * math.prod(shapes["b3_time"][0]), "f32")],
        4 * sum(math.prod(shapes[n][0]) + math.prod(shapes[n][0]) // shapes[n][0][d]
                for n, d in (("b3_features", -1), ("b3_time", -3))))
    return {"name": BF16_SUM, "route": "cuda", "source": "hig_tpu_torch/csrc/bf16_sum.cu",
            "replaces": "hig_tpu/ops/pallas_attention.py:97",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": sum(c["ms"] for c in pair), "plain_ms": sum(c["plain_ms"] for c in pair),
            "bound_ms": b_ms, "bound_by": b_by, "bound_kind": b_kind, "library_ms": None}


def b3_bf16_inputs(w, x, mask, tk: int):
    """B3-bf16's operands at x's shape with ``tk`` keys: the bfloat16 q, k, v
    projections of x (k, v cut to their first tk rows) and the keys' mask."""
    F = torch.nn.functional
    q, k, v = (to_bf16(F.linear(x, wt, b)) for wt, b in ((w.wq, w.bq), (w.wk, w.bk),
                                                          (w.wv, w.bv)))
    return (q, k[..., :tk, :].contiguous(), v[..., :tk, :].contiguous(), HEADS,
            mask[..., :tk].contiguous())


def b3_bf16_work(N: int, tq: int, tk: int) -> tuple[list, int]:
    """B3-bf16's bound inputs: its products (K^T V and q . state, bfloat16
    values) and its bytes (q, k, v, y in bfloat16, the float32 key mask)."""
    hd = D // HEADS
    return ([(2 * N * HEADS * hd * hd * (tq + tk), "bf16")],
            2 * (2 * N * tq * D + 2 * N * tk * D) + 4 * N * tk)


def check_efficient_attention_bf16(w, x, mask, failures) -> dict:
    """B3-bf16 through the model's ``_attend``, with Tq keys and with
    TK_SHORT, against its twin, beside the planted controls (the twin
    without each of B3_CORE_ROUNDINGS)."""
    from hig_tpu_torch.models import attention
    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention_plain as plain

    N, Tq = 2 * x.shape[0], x.shape[2]
    cases = {}
    for tk in (Tq, TK_SHORT):
        args = b3_bf16_inputs(w, x, mask, tk)
        got = attention._attend(*args)
        twin = plain(*args)
        twin32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
        twin_cpu = plain(*on_cpu(args))
        torch.cuda.synchronize()
        label = f"efficient_attention_bf16 {N}x{Tq}, {tk} keys"
        case = gate_bf16(label, got, twin, twin32, twin_cpu, failures)
        controls = {}
        for left_out in B3_CORE_ROUNDINGS:
            row = bf16_gate_row(plain(*args, unrounded=(left_out,)), twin, twin32, twin_cpu)
            fail_if(failures, row["passed"],
                    f"{label}: the twin without the {left_out} rounding passes: {row}")
            controls[left_out] = row["rms_ratio"]
        case["controls_rms_ratio"] = controls
        case["ms"] = time_ms(lambda: attention._attend(*args))
        case["plain_ms"] = time_ms(lambda: plain(*args))
        cases[f"tk{tk}"] = case
    return bf16_row("efficient_attention_bf16", "hig_tpu_torch/csrc/efficient_attention.cu",
                    "hig_tpu/ops/pallas_attention.py:46", [N, Tq, D, HEADS], cases,
                    *b3_bf16_work(N, Tq, Tq))


def sdpa_backend(q, k, v, bias) -> str:
    """The backend torch's scaled_dot_product_attention dispatches these
    inputs to (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, bias, 0.0, False)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:  # the chooser moved
        return f"unknown ({type(e).__name__})"


def check_flash_attention_bf16(w, x, mask, failures) -> dict:
    """B4-bf16 as the quadratic blocks call it (q, k, v views of one merged
    bfloat16 product; partner; causal; 91 queries on 77 keys), against its
    twin, and torch's scaled_dot_product_attention on the same bfloat16
    inputs (mask as a bfloat16 bias)."""
    from hig_tpu_torch.ops.flash_attention import flash_attention
    from hig_tpu_torch.ops.flash_attention import flash_attention_plain as plain

    F = torch.nn.functional
    N, Tq, hd = 2 * x.shape[0], x.shape[2], D // HEADS
    xb = to_bf16(x)
    wqkv = to_bf16(torch.cat([w.wq, w.wk, w.wv]))
    bqkv = to_bf16(torch.cat([w.bq, w.bk, w.bv]))
    q, k, v = (F.linear(xb, wqkv) + bqkv).chunk(3, dim=-1)
    pk, pv = (F.linear(xb, wqkv[D:]) + bqkv[D:]).chunk(2, dim=-1)
    cases = {"self": (q, k, v, HEADS, mask, False, False),
             "partner": (q, pk, pv, HEADS, mask, False, True),
             "causal": (q, k, v, HEADS, mask, True, False),
             f"tq{Tq}_tk{TK_SHORT}": (q.contiguous(), k[..., :TK_SHORT, :].contiguous(),
                                       v[..., :TK_SHORT, :].contiguous(), HEADS,
                                       mask[..., :TK_SHORT], False, False)}

    def heads(t):
        return t.reshape(N, t.shape[-2], HEADS, hd).transpose(1, 2)

    out, backend = {}, None
    for name, args in cases.items():
        qq, kk, vv, _, m, causal, partner = args
        Tk = kk.shape[-2]
        got = flash_attention(*args)
        twin = plain(*args)
        twin32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
        if partner:
            kk, vv, m = kk.flip(1), vv.flip(1), m.flip(1)
        bias = ((1.0 - m.reshape(N, 1, 1, Tk)) * -1e6).expand(N, 1, Tq, Tk)
        if causal:
            bias = bias + (torch.arange(Tk, device=x.device)[None, :]
                           > torch.arange(Tq, device=x.device)[:, None]) * -1e6
        sdpa = (heads(qq), heads(kk), heads(vv), to_bf16(bias).contiguous())
        torch.cuda.synchronize()
        out[name] = gate_bf16(f"flash_attention_bf16 {name} {N}x{Tq}", got, twin, twin32,
                              plain(*on_cpu(args)), failures)
        out[name]["ms"] = time_ms(lambda: flash_attention(*args))
        out[name]["plain_ms"] = time_ms(lambda: plain(*args))
        out[name]["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            *sdpa[:3], attn_mask=sdpa[3]))
        backend = backend or sdpa_backend(*sdpa)
    path = {c: out[c] for c in ("self", "partner", "causal")}
    flops = 2 * 2 * N * HEADS * Tq * Tq * hd  # q·kᵀ and P·v, products of bfloat16 values
    nbytes = 2 * (4 * N * Tq * D) + 4 * N * Tq
    row = bf16_row("flash_attention_bf16", "hig_tpu_torch/csrc/flash_attention.cu",
                   "hig_tpu/ops/flash_attention.py:53", [N, Tq, D, HEADS], path,
                   [(flops, "bf16")], nbytes,
                   {"library_ms": max(c["library_ms"] for c in path.values()),
                    "library_backend": backend, "tq_ne_tk": out[f"tq{Tq}_tk{TK_SHORT}"]})
    row["library_backend"] = backend
    row["max_abs_err"] = max(c["max_abs_err"] for c in out.values())
    return row


def bf16_kernel_rows(device, failures) -> dict:
    """Each bfloat16 form and B2-bf16a at the serving shape, then at the
    evaluation chunk's shape (under "eval_shape"); B2-bf16a also at the
    labeling shape (a vote's 64 pairs under both assignments), B3-bf16 at
    the training shape (a PIT step's 32 pairs under both assignments) with
    its backward against the same on the CPU."""
    checks = {"fused_block_bf16": check_fused_block_bf16,
              "projected_attention_bf16": check_projected_attention_bf16,
              MIXED_FORM: check_projected_attention_bf16a,
              "efficient_attention_bf16": check_efficient_attention_bf16,
              "flash_attention_bf16": check_flash_attention_bf16}
    keys = (*TRAIN_SHAPE_KEYS, "rms_ratio")
    rows = {}
    extra = {MIXED_FORM: ("split_ms",)}
    for shape, inputs in (("serve", block_inputs(device)),
                          ("eval", block_inputs(device, EVAL_CLIPS, EVAL_T))):
        for name, check in checks.items():
            row = check(*inputs, failures) if name == "fused_block_bf16" else \
                check(*inputs[:3], failures)
            if shape == "serve":
                rows[name] = row
            else:
                rows[name]["eval_shape"] = {k: row[k] for k in (*keys, *extra.get(name, ()))}
    inputs = block_inputs(device, 2 * LABEL_BATCH)
    rows[MIXED_FORM]["label_shape"] = {
        k: v for k, v in check_projected_attention_bf16a(*inputs[:3], failures).items()
        if k in (*keys, *extra[MIXED_FORM])}
    inputs = block_inputs(device, 2 * TRAIN_PAIRS)
    rows["efficient_attention_bf16"]["train_shape"] = {
        k: v for k, v in check_efficient_attention_bf16(*inputs[:3], failures).items()
        if k in keys}
    backward = check_b3_bf16_backward(*inputs[:3])
    print(json.dumps({"phase": "kernel_bf16_backward", "kernel": "efficient_attention_bf16",
                      **backward}), flush=True)
    fail_if(failures, not backward.pop("passed"), f"B3-bf16 backward on the card: {backward}")
    rows["efficient_attention_bf16"]["train_shape"]["backward"] = backward
    rows[BF16_SUM] = check_bf16_sum(device, failures)
    return rows


def bf16_models(f32_models: dict, device) -> dict:
    """The bfloat16 models at full width, parameters cast once, with the
    phase-4 models' weights: fused, fast_ln and guided (whose null
    conditioning is drawn from a seed, N(0, 1) as ``random_flax_tree``
    draws it) the fused model's, projected and rms_norm (RMSNorm keeps the
    LayerNorms' scales) the projected one's, no_eff its own."""
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.weights import cast_floating

    gen = torch.Generator().manual_seed(3)
    models = {}
    for run, base, extra in (("fused", "fused", {}), ("projected", "projected", {}),
                             ("no_eff", "no_eff", {}), ("fast_ln", "fused", {"fast_ln": True}),
                             ("rms_norm", "projected", {"rms_norm": True}),
                             ("guided", "fused", {"cond_drop_prob": 0.1})):
        src = f32_models[base].state_dict()
        model = InteractionModel(dataclasses.replace(f32_models[base].cfg,
                                                     compute_dtype="bfloat16", **extra))
        model.load_state_dict({k: src[k] if k in src else torch.randn(v.shape, generator=gen)
                               for k, v in model.state_dict().items()})
        models[run] = cast_floating(model.to(device), torch.bfloat16).eval()
    return models


def f32_twin_model(model):
    """The float32 model with ``model``'s bfloat16-rounded weights."""
    from hig_tpu_torch.models.interaction_model import InteractionModel

    twin = InteractionModel(dataclasses.replace(model.cfg, compute_dtype="float32"))
    twin.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    return twin.to(next(model.parameters()).device).eval()


def route_row(got, plain16, plain32) -> dict:
    """A route against the plain route (see BF16_ROUTE_RMS): the readings,
    and under "passed" whether ``got`` meets the limit."""
    got, plain16, plain32 = (np.asarray(a, np.float64) for a in (got, plain16, plain32))
    rms = float(np.sqrt(np.mean((got - plain16) ** 2)))
    ref = float(np.sqrt(np.mean((plain16 - plain32) ** 2)))
    return {"rms_vs_plain_bf16": rms, "rms_plain_bf16_vs_f32": ref,
            "rms_ratio": rms / ref if ref else None, "rms_ratio_lim": BF16_ROUTE_RMS,
            "max_abs_out": float(np.abs(plain16).max()),
            "passed": bool(np.isfinite(got).all() and rms <= BF16_ROUTE_RMS * ref)}


def route_gate(label, got, plain16, plain32, failures) -> dict:
    row = route_row(got, plain16, plain32)
    fail_if(failures, not row.pop("passed"), f"{label}: {row}")
    return row


def first_layer(model):
    """``model`` cut to its first layer: full width, the same weights and dtype."""
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.weights import cast_floating

    cut = InteractionModel(dataclasses.replace(model.cfg, num_layers=1))
    state = model.state_dict()
    cut.load_state_dict({k: state[k] for k in cut.state_dict()})
    return cast_floating(cut.to(next(model.parameters()).device), model.cfg.dtype).eval()


def phase_bf16(f32_models: dict, device, failures, smi: str, tmp: str) -> tuple:
    """Phase 10 (see the module doc). Returns (the bfloat16 kernel rows with
    their launches, and for the profile {run: (call, replayed wall s or
    None)}: the serving calls and the ``evaluate`` run's first chunk, all
    replays)."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train.trainer import make_sampler

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows = bf16_kernel_rows(device, failures)
    launches = {form: 0 for form in (*BF16_FORMS, MIXED_FORM, BF16_SUM)}
    models = bf16_models(f32_models, device)

    # denoiser: one full-width call per model through the kernels, against
    # the plain route in bfloat16 and in float32 on the same inputs, at
    # full depth (reported) and at the first layer (held, with the control)
    gen = torch.Generator().manual_seed(2)
    cfg = models["fused"].cfg
    x = torch.randn((N_PAIRS, 2, T, cfg.input_feats), generator=gen).to(device)
    t = torch.full((N_PAIRS,), 500, device=device)
    lengths = torch.tensor(LENGTHS, device=device) + 1
    xf_proj = to_bf16(torch.randn((N_PAIRS, 2, cfg.time_embed_dim), generator=gen).to(device))
    xf_out = to_bf16(torch.randn((N_PAIRS, 2, 77, cfg.text_latent_dim), generator=gen)
                     .to(device))
    # the same conditioning with one element a pair moved by one bfloat16 ulp
    xf_proj_ulp = xf_proj.clone()
    xf_proj_ulp[:, 0, 0] = (xf_proj_ulp[:, 0, 0].view(torch.int16) + 1).view(torch.bfloat16)
    with torch.no_grad():
        for run, form in BF16_DENOISER_RUNS.items():
            model = models[run]
            twin = f32_twin_model(model)
            got = model.denoise(x, t, lengths, xf_proj, xf_out)
            with plain_blocks():
                p16 = model.denoise(x, t, lengths, xf_proj, xf_out)
                p32 = twin.denoise(x, t, lengths, xf_proj.float(), xf_out.float())
                p16_ulp = model.denoise(x, t, lengths, xf_proj_ulp, xf_out)
            del twin
            row = route_row(got.float().cpu(), p16.float().cpu(), p32.cpu())
            del row["passed"]  # reported: see BF16_ROUTE_RMS
            ulp = (p16_ulp.float() - p16.float()).pow(2).mean().sqrt().item()
            row.update(rms_plain_bf16_one_ulp_a_pair=ulp,
                       one_ulp_ratio=ulp / row["rms_plain_bf16_vs_f32"])
            fail_if(failures, got.dtype != torch.bfloat16
                    or not torch.isfinite(got.float()).all(),
                    f"bf16 denoiser ({run}): {got.dtype}, {row}")
            cut = first_layer(model)
            twin = f32_twin_model(cut)
            got = cut.denoise(x, t, lengths, xf_proj, xf_out)
            with plain_blocks():
                p16 = cut.denoise(x, t, lengths, xf_proj, xf_out).float().cpu()
                p32 = twin.denoise(x, t, lengths, xf_proj.float(), xf_out.float()).cpu()
            with plain_blocks(control=True):
                control = route_row(cut.denoise(x, t, lengths, xf_proj, xf_out).float().cpu(),
                                    p16, p32)
            del cut, twin
            first = route_gate(f"bf16 denoiser ({run}, first layer)", got.float().cpu(), p16,
                               p32, failures)
            if form in FORMS_WITH_INNER_ROUNDINGS:
                fail_if(failures, control["passed"],
                        f"bf16 denoiser ({run}, first layer): the control passes: {control}")
            print(json.dumps({"phase": "bf16_denoiser", "run": run, "full_depth": row,
                              "first_layer": first,
                              "first_layer_control_rms_ratio": control["rms_ratio"]}),
                  flush=True)

    # serving: 8 requests, DDIM-50, through each run's bfloat16 form
    requests = serve_requests()
    sched = g.make_schedule(g.linear_betas(1000))
    mean, std = serve.load_stats(None, cfg.input_feats)
    runs = {}
    for run, (own, w) in BF16_SERVE_RUNS.items():
        model = models[run]
        twin = f32_twin_model(model)
        t_run = time.perf_counter()
        kw = dict(T=T, dim_pose=cfg.input_feats, ddim_steps=DDIM_STEPS, guidance_scale=w)
        sample_fn = make_sampler(model, sched, **kw)
        call = serve_with(sample_fn, requests, mean, std)
        eager = serve_with(make_sampler(model, sched, graph=False, **kw), requests, mean, std)
        graph_row, (features, joints), first, call_counts = graph_and_eager(
            f"bf16 serve ({run})", call, eager, sample_fn.graphs, failures)
        twin_fn = make_sampler(twin, sched, graph=False, **kw)
        with plain_blocks():
            p16, _ = eager(torch.Generator(device=device).manual_seed(0))
            p32, _ = serve.serve_batch(twin_fn, requests, mean, std, device,
                                       torch.Generator(device=device).manual_seed(0))
        with plain_blocks(control=True):
            control = route_row(eager(torch.Generator(device=device).manual_seed(0))[0],
                                p16, p32)
        del twin, twin_fn
        row = route_gate(f"bf16 serve ({run})", features, p16, p32, failures)
        row["control_rms_ratio"] = control["rms_ratio"]
        wall = graph_row["wall_s_per_call"]
        print(json.dumps({"phase": "bf16_serve", "run": run, "nvidia_smi": smi,
                          "guidance_scale": w, "requests": len(requests), "T": T,
                          "ddim_steps": DDIM_STEPS, "launches": call_counts[0], **graph_row,
                          "finite": bool(np.isfinite(features).all()
                                         and np.isfinite(joints).all()),
                          "joints_shape": list(joints.shape), **row,
                          "seconds": time.perf_counter() - t_run}), flush=True)
        fail_if(failures, any(c[name] != (LAUNCHES_PER_CALL if name == own else 0)
                              for c in call_counts for name in c)
                or any(first[name] != (FIRST_CALL if name == own else 0) for name in first),
                f"bf16 serve ({run}) launches {first}, {call_counts}")
        fail_if(failures, tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3)
                or not np.isfinite(joints).all(), f"bf16 serve ({run}) joints {joints.shape}")
        launches[own] += call_counts[0][own]
        runs[f"serve_bf16_{run}"] = (seeded(call), wall)
    del models

    n, runs["evaluate_bf16"] = bf16_evaluate(failures, smi, tmp)
    launches["fused_block_bf16"] += n
    for form, row in rows.items():
        row["launches"] = launches[form]
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"phase": "bf16", "seconds": seconds}), flush=True)
    return rows, runs


def bf16_evaluate(failures, smi: str, tmp: str) -> tuple:
    """``python -m hig_tpu_torch.evaluate``'s main from stage 1-3's
    checkpoint as a bfloat16 run (a copy of its opt.txt with
    ``compute_dtype: bfloat16``) with --fast_ln, DPM-20 at T = 196. Returns
    its B1-bf16 launches and (its first chunk again, None) for the
    profile."""
    from hig_tpu_torch import evaluate

    opt = os.path.join(tmp, "cfg_supervised_eval_opt.txt")
    with open(opt) as f:
        text = f.read()
    fail_if(failures, "compute_dtype: float32\n" not in text, "stage 1-3's opt.txt: no dtype")
    opt_bf16 = os.path.join(tmp, "cfg_supervised_bf16_opt.txt")
    with open(opt_bf16, "w") as f:
        f.write(text.replace("compute_dtype: float32\n", "compute_dtype: bfloat16\n"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with spy_samplers(evaluate) as made:
        out = evaluate.main(["--opt_path", opt_bf16, "--mm_num_times", "1", "--file_id", "bf16",
                             *BF16_EVAL_RUN])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bf16_counts()
    with open(os.path.join(out["save_dir"], "summarybf16.json")) as f:
        summary = json.load(f)
    cm = np.load(os.path.join(out["save_dir"], "confusion_matrixbf16_rep0.npy"))
    values = [v for models_ in summary.values() for mv in models_.values() for v in mv]
    means = {m: {k: v[0] for k, v in summary.get(m, {}).items()} for m in METRICS}
    print(json.dumps({"phase": "bf16_evaluate", "nvidia_smi": smi, "args": BF16_EVAL_RUN,
                      "test_clips": EVAL_CLIPS, "launches": counts,
                      "expected_b1_bf16": BF16_EVAL_LAUNCHES, "wall_s": wall,
                      "graphs": list(out["graphs"].values()),
                      "summary": summary, "confusion_sum": int(cm.sum())}), flush=True)
    want = BF16_EVAL_LAUNCHES + LAUNCHES_PER_STEP * len(out["graphs"])
    fail_if(failures, any(counts[n] != (want if n == "fused_block_bf16" else 0)
                          for n in counts), f"bf16 evaluate launches {counts}, expected {want}")
    fail_if(failures, list(summary) != list(METRICS) or not np.isfinite(values).all()
            or not all(0.0 <= v <= 1.0 for m in ("Acc", "Consistency")
                       for v in means[m].values())
            or not all(v >= 0.0 for v in means["FID"].values()),
            f"bf16 evaluate summary {summary}")
    fail_if(failures, int(cm.sum()) != EVAL_CLIPS, f"bf16 evaluate confusion sum {cm.sum()}")
    return counts["fused_block_bf16"], (first_chunk(made[0]), None)


# --- phase 11: bfloat16 training and labeling ------------------------------------------

# bfloat16 runs of python -m hig_tpu_torch.train at full width, global batch
# 32, T = 91, on phase 6's dataset: run → (extra arguments, steps,
# validation batches, the form its attention blocks launch). The efficient
# blocks take JAX's einsum route in train mode, through B3-bf16 (the
# validation pass too); the quadratic ones B4-bf16.
BF16 = ["--compute_dtype", "bfloat16"]
BF16_TRAIN_RUNS = {
    "pit_bf16": (["--times", "3", *BF16], 4, 0, "efficient_attention_bf16"),
    "pit_bf16_rms_norm": (["--times", "2", "--limit_data_num", "32", *BF16, "--rms_norm",
                           "--fast_ln"], 2, 0, "efficient_attention_bf16"),
    "pit_bf16_no_eff": (["--times", "2", "--limit_data_num", "32", *BF16, "--no_eff"], 2, 0,
                        "flash_attention_bf16"),
    "supervised_bf16": (["--times", "2", "--limit_data_num", "32", *BF16, "--label_path",
                         "{data}/labels.json", "--cond_drop_prob", "0.1", "--eval_every_e", "1"],
                        2, VAL_CLIPS // TRAIN_PAIRS, "efficient_attention_bf16"),
}
BF16_GRAD_RUNS = ("pit_bf16", "pit_bf16_rms_norm", "pit_bf16_no_eff")
BF16_SUM_AB_STEPS = 4  # bf16 PIT steps a turn, the sum's kernel against its loop
# One batch's loss and every gradient through the kernels against the plain
# bfloat16 route (each kernel's twin, under the same bfloat16 backward), at
# the model cut to its first layer (full width, the run's initial float32
# weights), each as a fraction of the bfloat16 effect (the plain route
# against the plain route of the float32 model on the same weights), over
# every leaf but the key biases (exact gradient 0: rounding noise). The two
# routes differ only where a float32 sum in another order flips a rounding
# of the forward, and each flip reshuffles the bfloat16 backward's rounding
# noise downstream (0.12-0.15 of the effect in the gradients at full
# width). The control route must exceed the limit in the loss or the
# gradients: for the efficient blocks, JAX's use_pallas forward (B2's twin
# on bfloat16 activations with the float32 weights: unrounded q|k|v
# products, a float32 core), whose VJP JAX cannot take; for the quadratic
# ones, B4's float32 plain version on the upcast inputs, output rounded. The
# core's own roundings are a small part of the model's bfloat16 effect at
# full width: B3's float32 core, output rounded, reads 0.02 of it in the loss
# and 0.15 in the gradients, within the noise (PERF.md §6).
BF16_TRAIN_RMS = 0.2


@contextlib.contextmanager
def use_pallas_forward():
    """The efficient blocks' train-mode route swapped for JAX's
    ``use_pallas=True`` forward of a bfloat16 model on float32 weights (B2's
    twin on those dtypes, under autograd), the other kernels plain: phase
    11's control route for the efficient runs."""
    from hig_tpu_torch.models import attention
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain

    def route(block, xn, mask, weights, heads):
        kv, kv_mask = (xn.flip(-3), mask.flip(-2)) if block.interaction else (xn, mask)
        return fused_projected_attention_plain(xn, kv, *weights, heads, kv_mask)

    saved = attention._KernelBlock._einsum_route
    attention._KernelBlock._einsum_route = route
    try:
        with plain_blocks():
            yield
    finally:
        attention._KernelBlock._einsum_route = saved


def float32_state(state, model_dir: str) -> dict:
    """The floating dtypes of the run's parameters, Adam moments, EMA and
    latest checkpoint."""
    from hig_tpu_torch.train import checkpoint as ckpt

    def kinds(tensors):
        return sorted({str(t.dtype) for t in tensors if torch.is_tensor(t) and t.is_floating_point()})

    saved = ckpt.load(os.path.join(model_dir, "latest.pt"))["params"]
    return {"params": kinds(state.model.parameters()),
            "adam": kinds(state.optimizer.exp_avg + state.optimizer.exp_avg_sq),
            "ema": kinds((state.ema or {}).values()), "checkpoint": kinds(saved.values())}


def train_cut(model, compute_dtype: str | None = None):
    """``model`` cut to its first layer in train mode: full width, the same
    float32 weights, its compute dtype or ``compute_dtype``."""
    from hig_tpu_torch.models.interaction_model import InteractionModel

    cfg = dataclasses.replace(model.cfg, num_layers=1,
                              compute_dtype=compute_dtype or model.cfg.compute_dtype)
    cut = InteractionModel(cfg)
    state = model.state_dict()
    cut.load_state_dict({k: state[k] for k in cut.state_dict()})
    return cut.to(next(model.parameters()).device).train()


def tree_rms_ratio(got: dict, want: dict, want32: dict) -> float:
    """rms(got − want) ÷ rms(want − want32) over the leaves of ``want`` at
    once, but the key biases'."""
    keys = sorted(k for k in want if not k.endswith(KEY_BIAS))
    cat = [torch.cat([d[k].double().ravel() for k in keys]) for d in (got, want, want32)]
    return float((cat[0] - cat[1]).pow(2).mean().sqrt() / (cat[1] - cat[2]).pow(2).mean().sqrt())


def bf16_grad_gate(sched, batch: dict, initial, run: str, failures, beside=None) -> dict:
    """The kernel route against the plain bfloat16 route (BF16_TRAIN_RMS),
    with the control route beside it, on the run's first batch and initial
    weights (``first_batch``); ``beside`` ({name: context}) adds routes read
    against the plain route and reported, not held."""
    from hig_tpu_torch.train import trainer as tr

    cut, cut32 = train_cut(initial), train_cut(initial, "float32")
    device = batch["motion"].device
    gen = torch.Generator(device=device).manual_seed(5)
    t = torch.randint(0, 1000, (TRAIN_PAIRS,), generator=gen, device=device)
    noise = torch.randn(batch["motion"].shape, generator=gen, device=device)
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}

    def route(model, b, ctx):
        with ctx:
            loss, _ = tr.compute_grads(model, tr.make_loss_fn(model, sched, True), b,
                                       t=t, noise=noise)
        return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss_k, g_k = route(cut, batch, contextlib.nullcontext())
    loss_p, g_p = route(cut, batch, plain_blocks())
    control_route = use_pallas_forward() if cut.cfg.efficient else plain_blocks(control=True)
    loss_c, g_c = route(cut, batch, control_route)
    loss_32, g_32 = route(cut32, batch32, plain_blocks())
    effect = abs(loss_p - loss_32)

    def reading(loss, grads):
        return {"loss_ratio": abs(loss - loss_p) / effect,
                "grad_ratio": tree_rms_ratio(grads, g_p, g_32)}

    kernel, control = reading(loss_k, g_k), reading(loss_c, g_c)
    also = {name: reading(*route(cut, batch, ctx)) for name, ctx in (beside or {}).items()}
    worst = max((n for n in g_p if not n.endswith(KEY_BIAS)),
                key=lambda n: ((g_k[n] - g_p[n]).double().pow(2).mean()
                               / (g_p[n] - g_32[n]).double().pow(2).mean().clamp_min(1e-60)))
    out = {"layers": 1, "loss_kernels": loss_k, "loss_plain_bf16": loss_p,
           "loss_plain_f32": loss_32, "leaves": len(g_p), "kernels": kernel, "control": control,
           "worst_leaf": worst, "worst_leaf_ratio": tree_rms_ratio(
               {worst: g_k[worst]}, {worst: g_p[worst]}, {worst: g_32[worst]}),
           "lim": BF16_TRAIN_RMS, **({"beside": also} if also else {})}
    fail_if(failures, not (g_k.keys() == g_p.keys() and max(kernel.values()) <= BF16_TRAIN_RMS),
            f"bf16 train ({run}): kernel route against plain route {out}")
    fail_if(failures, max(control.values()) <= BF16_TRAIN_RMS,
            f"bf16 train ({run}): the control route passes {out}")
    return out


LAZY_STEPS = 3  # the lazy step's run: the first eager, then the capture, then replays


def lazy_pit_step(trainer, batch: dict, initial, failures, smi: str) -> dict:
    """The bfloat16 PIT step under LAZY_KNORM (B3-bf16's lazy forms), from
    the run's initial weights and first batch: LAZY_STEPS steps through the
    graph and eagerly, one generator seed each, whose metrics, parameters
    and Adam's moments must be equal bit for bit, with 16 launches a step of
    the lazy form and none of the eager one or of another form's; one
    batch's loss and gradients at the first-layer cut through the kernels
    against the lazy plain route within BF16_TRAIN_RMS of the bfloat16
    effect (beside the control route), and the same step without the flag
    within BF16_TRAIN_RMS of the lazy plain route too."""
    from hig_tpu_torch.train import trainer as tr

    weights = {k: v.detach() for k, v in initial.state_dict().items()}
    device = batch["motion"].device
    row = {"phase": "bf16_train", "run": "pit_bf16_lazy_knorm", "nvidia_smi": smi,
           "pairs_per_step": TRAIN_PAIRS, "steps": LAZY_STEPS}
    finals, counts = [], []
    with lazy_knorm():
        for graph in (True, False):
            model = model_from(trainer.model_config, weights, device).train()
            state = tr.TrainState(model=model, optimizer=tr.make_optimizer(trainer.cfg, model))
            step = tr.make_train_step(trainer.sched, True, graph=graph)
            gen = torch.Generator(device=device).manual_seed(11)
            reset_counts()
            metrics, ms = [], []
            for _ in range(LAZY_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch, gen)
                metrics.append([float(out[k]) for k in tr.TRAIN_METRICS])
                ms.append(1e3 * (time.perf_counter() - t0))
            counts.append(bf16_counts())
            finals.append(final_state_tensors(state))
            key = "graphed" if graph else "eager"
            row[key] = {"metrics": metrics, "step_ms": ms}
            if graph:
                row[key]["capture"] = next(iter(step.graphs.values())).summary()
            del model, state, step
        row["grads"] = bf16_grad_gate(trainer.sched, batch, initial, "pit_bf16_lazy_knorm",
                                      failures, beside={"without_flag": lazy_knorm(False)})
    differ = [n for n, t in finals[1].items() if not torch.equal(finals[0][n], t)]
    row.update(launches=counts[0], eager_launches=counts[1], differ=differ,
               metrics_equal=row["graphed"]["metrics"] == row["eager"]["metrics"])
    want = LAZY_STEPS * LAUNCHES_PER_STEP
    fail_if(failures, bool(differ) or not row["metrics_equal"],
            f"lazy PIT step: graphed against eager {row}")
    without = row["grads"]["beside"]["without_flag"]
    fail_if(failures, not max(without.values()) <= BF16_TRAIN_RMS,
            f"lazy PIT step: the step without the flag against the lazy plain route {without}")
    fail_if(failures, any(c[n] != (want if n == LAZY_FORM else 0) for c in counts for n in c),
            f"lazy PIT step: launches {counts}, expected {want} of {LAZY_FORM}")
    del finals
    return row


def bf16_scorer_rows(model_config, model_dir: str, cfg, fused: bool, own: str, failures) -> tuple:
    """The labeling scorer of a bfloat16 run (float32 parameters) through
    its kernels against the plain route on one batch of LABEL_BATCH pairs:
    at the model cut to its first layer, held to BF16_ROUTE_RMS of the
    bfloat16 effect (the float32 model's plain scorer); at full depth
    reported, with the votes that differ. Returns (the readings, a function
    running one vote through the kernels)."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.data.dataset import PairDataset, epoch_batches
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.train import checkpoint as ckpt
    from hig_tpu_torch.train import labeling

    device = torch.device("cuda")
    sched = g.make_schedule(g.linear_betas(1000))
    model = InteractionModel(dataclasses.replace(model_config, fused_blocks=fused))
    model.load_state_dict(ckpt.load(os.path.join(model_dir, "latest.pt"))["params"])
    model = model.to(device)
    mean, std = serve.load_stats(cfg.meta_dir, cfg.dim_pose)
    b = next(epoch_batches(PairDataset(cfg, mean, std, "train_sub.txt"), LABEL_BATCH, 0,
                           shuffle=False, drop_last=False))
    cond = torch.from_numpy(b["cap_ids"] if cfg.cap_id else b["tokens"]).long().to(device)
    motion = torch.from_numpy(b["motion"]).to(device)
    lengths = torch.from_numpy(b["lengths"]).long().to(device)
    noise = torch.randn(motion.shape, generator=torch.Generator(device=device).manual_seed(3),
                        device=device)
    t_vote = labeling.LABEL_T_VALUES[0]

    def scores(m, ctx=contextlib.nullcontext()):
        encode, score = labeling.make_assignment_scorer(m, sched)
        with ctx:
            xf_proj, xf_out = encode(cond, cond.flip(1))
            return score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)

    rows = {}
    for depth, m in (("first_layer", train_cut(model)), ("full_depth", model)):
        reset_counts()
        got = scores(m)
        counts = bf16_counts()
        p16 = scores(m, plain_blocks())
        twin = f32_twin_model(m)
        p32 = scores(twin, plain_blocks())
        del twin
        row = route_row(got.cpu(), p16.cpu(), p32.cpu())
        differ = got.argmin(dim=1) != p16.argmin(dim=1)
        row.update(launches=counts, votes_differing=int(differ.sum()), pairs=LABEL_BATCH)
        want = 2 * m.cfg.num_layers  # the self-attention and interaction blocks
        fail_if(failures, any(counts[n] != (want if n == own else 0) for n in counts),
                f"bf16 scorer ({own}, {depth}) launches {counts}")
        if depth == "first_layer":
            fail_if(failures, not row["passed"], f"bf16 scorer ({own}, first layer): {row}")
        del row["passed"]
        rows[depth] = row

    encode, score = labeling.make_assignment_scorer(model, sched)
    xf_proj, xf_out = encode(cond, cond.flip(1))

    def vote():
        return score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)

    vote_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vote()
        torch.cuda.synchronize()
        vote_s.append(time.perf_counter() - t0)
    rows["vote_ms"] = [1e3 * x for x in vote_s]
    return rows, (vote, statistics.median(vote_s))


def phase_bf16_train(device, failures, smi: str, requests: list, data: str, tmp: str,
                     f32_pit: dict) -> tuple:
    """Phase 11 (see the module doc). Returns (the launches of each form,
    {run: call} and {run: wall s or None} of one bfloat16 PIT step, the two
    bfloat16 labeling votes and one more serving call from the bfloat16
    checkpoint (a replay), profiled last)."""
    from hig_tpu_torch import label, serve
    from hig_tpu_torch.data.vocab import CAP2KEY, CLASSID2CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import labeling
    from hig_tpu_torch.train import trainer as tr

    t_phase = time.perf_counter()
    launches: dict = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    runs, kept = {}, {}
    for run, (extra, steps, val_batches, own) in BF16_TRAIN_RUNS.items():
        if run == "pit_bf16":
            trainer, state, row, counts = graphed_and_eager_run(run, extra, steps, own, data,
                                                                tmp, failures, smi)
        else:
            trainer, state, row, counts = train_run(run, extra, steps, own, data, tmp, failures,
                                                    smi, val_batches=val_batches)
        add(counts)
        cfg = trainer.cfg
        dtypes = float32_state(state, cfg.model_dir)
        row.update(phase="bf16_train", compute_dtype=cfg.compute_dtype, float32_state=dtypes,
                   float32_pit_phase6=f32_pit,
                   step_ms_ratio_to_float32_pit=row["median_ms_per_step_after_first"]
                   / f32_pit["step_ms"])
        fail_if(failures, any(v not in ([], ["torch.float32"]) for v in dtypes.values())
                or not dtypes["params"] or not dtypes["adam"] or not dtypes["checkpoint"],
                f"bf16 train ({run}): state not float32 {dtypes}")
        if run in BF16_GRAD_RUNS:
            batch, initial = first_batch(trainer)
            row["grad_check"] = bf16_grad_gate(trainer.sched, batch, initial, run, failures)
            if run == "pit_bf16":
                lazy_row = lazy_pit_step(trainer, batch, initial, failures, smi)
                print(json.dumps(lazy_row), flush=True)
                add({LAZY_FORM: lazy_row["launches"][LAZY_FORM]
                     + lazy_row["eager_launches"][LAZY_FORM]})
            del initial
        print(json.dumps(row), flush=True)
        if run == "pit_bf16":
            kept = {"trainer": trainer, "state": state, "batch": batch, "cfg": cfg,
                    "step_s": row["median_ms_per_step_after_first"] / 1e3,
                    "eager_step_s": row["eager"]["median_ms_per_step_after_first"] / 1e3}
        elif run == "pit_bf16_rms_norm":
            kept["rms"] = (trainer.model_config, cfg)
        del trainer, state

    # labeling: the LayerNorm run through B1-bf16 (fused, its default), the
    # rms_norm run through B2-bf16a (projected, its default)
    pit_cfg = kept["cfg"]
    for run_cfg, flags, own in ((pit_cfg, ("--label_model", "--save_label"), "fused_block_bf16"),
                                (kept["rms"][1], ("--label_model",), MIXED_FORM)):
        opt = os.path.join(run_cfg.save_root, "opt.txt")
        for flag in flags:
            clips, repeats = ((ANN_CLIPS, labeling.DISCOVERY_REPEATS) if flag == "--label_model"
                              else (TRAIN_CLIPS, labeling.LABELING_REPEATS))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            label.main(["--opt_path", opt, flag, "--batch_size", str(LABEL_BATCH)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = bf16_counts()
            add(counts)
            forwards = -(-clips // LABEL_BATCH) * len(labeling.LABEL_T_VALUES) * repeats
            print(json.dumps({"phase": "bf16_label", "run": run_cfg.name, "flag": flag[2:],
                              "nvidia_smi": smi, "clips": clips, "forwards": forwards,
                              "launches": counts, "wall_s": wall,
                              "forwards_per_s": forwards / wall}), flush=True)
            want = LAUNCHES_PER_STEP * forwards
            fail_if(failures, any(counts[n] != (want if n == own else 0) for n in counts),
                    f"bf16 label {run_cfg.name} {flag}: launches {counts}, expected {want} of "
                    f"{own}")
        with open(os.path.join(run_cfg.save_root, "pit_labels.json")) as f:
            roles = json.load(f)
        asymmetric = [c for c, (a, p) in enumerate(CLASSID2CAPS) if a != p]
        fail_if(failures, len(roles) != len(CLASSID2CAPS) or not all(
            {roles[str(c)].get("active_index"), roles[str(c)].get("passive_index")}
            == {CAP2KEY[CLASSID2CAPS[c][0]], CAP2KEY[CLASSID2CAPS[c][1]]} for c in asymmetric),
            f"bf16 label {run_cfg.name}: pit_labels.json incomplete: {roles}")
    with open(os.path.join(data, "pseudo_labels.json")) as f:
        labels = json.load(f)
    with open(os.path.join(data, "train_sub.txt")) as f:
        train_names = f.read().split()
    fail_if(failures, set(labels) != set(train_names) or not set(labels.values()) <= {0, 1},
            f"bf16 label: pseudo_labels.json incomplete: {labels}")

    # both scorers on one batch against the plain route
    walls = {}
    trainer = kept["trainer"]
    for name, (mcfg, cfg, fused, own) in {
            "fused": (trainer.model_config, pit_cfg, True, "fused_block_bf16"),
            "rms_norm_projected": (*kept["rms"], False, MIXED_FORM)}.items():
        rows, (vote, vote_s) = bf16_scorer_rows(mcfg, cfg.model_dir, cfg, fused, own, failures)
        print(json.dumps({"phase": "bf16_scorer", "scorer": name, "nvidia_smi": smi, **rows}),
              flush=True)
        run = "label_vote_bf16" if name == "fused" else "label_vote_bf16_rms_norm"
        runs[run], walls[run] = vote, vote_s
        del vote

    # 8 requests served in bfloat16 from the PIT run's checkpoint (cast once)
    model = serve.build_model(dataclasses.replace(trainer.model_config, fused_blocks=True),
                              device, params=os.path.join(pit_cfg.model_dir, "latest.pt"))
    mean, std = serve.load_stats(pit_cfg.meta_dir, model.cfg.input_feats)
    sample_fn = tr.make_sampler(model, g.make_schedule(g.linear_betas(1000)), T=T,
                                dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    features, joints = serve.serve_batch(sample_fn, requests, mean, std, device,
                                         torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bf16_counts()
    add(counts)
    finite = bool(np.isfinite(features).all() and np.isfinite(joints).all())
    print(json.dumps({"phase": "bf16_serve_trained", "checkpoint": "pit_bf16/model/latest.pt",
                      "requests": len(requests), "launches": counts, "wall_s": wall,
                      "finite": finite, "joints_shape": list(joints.shape)}), flush=True)
    fail_if(failures, not finite or tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3)
            or any(counts[n] != (FIRST_CALL if n == "fused_block_bf16" else 0)
                   for n in counts),
            f"serving the bf16 checkpoint: finite {finite}, shape {joints.shape}, {counts}")
    runs["serve_bf16_trained"] = seeded(serve_with(sample_fn, requests, mean, std))
    walls["serve_bf16_trained"] = None

    # eager steps: a replay would not see plain_sum's swap
    eager_step = tr.make_train_step(trainer.sched, True, graph=False)
    step_gen = torch.Generator(device=device).manual_seed(9)

    def one_step():
        return {k: float(v) for k, v in eager_step(kept["state"], kept["batch"],
                                                   step_gen).items()}

    # the ordered bfloat16 sum's kernel against its plain loop in the same
    # step, in turns (kernel, plain, plain, kernel), host clock
    ab: dict = {"kernel": [], "plain": []}
    for mode in ("kernel", "plain", "plain", "kernel"):
        with plain_sum() if mode == "plain" else contextlib.nullcontext():
            for _ in range(BF16_SUM_AB_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_step()
                ab[mode].append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"phase": "bf16_sum_step_ab", "run": "pit_bf16", "nvidia_smi": smi,
                      "step_ms": ab, "median_ms": {m: statistics.median(v)
                                                   for m, v in ab.items()}}), flush=True)

    train_step = tr.make_train_step(trainer.sched, True)

    def replayed_step():
        return {k: float(v) for k, v in train_step(kept["state"], kept["batch"],
                                                   step_gen).items()}

    replayed_step()  # eager, then the capture: the profile traces a replay
    runs["train_step_pit_bf16"], walls["train_step_pit_bf16"] = replayed_step, kept["step_s"]
    runs["train_step_pit_bf16_eager"] = one_step
    walls["train_step_pit_bf16_eager"] = kept["eager_step_s"]
    print(json.dumps({"phase": "bf16_train_label", "seconds": time.perf_counter() - t_phase,
                      "launches": launches}), flush=True)
    return launches, runs, walls


# --- phase 12: the paper's ablation models ---------------------------------------------

# A --no_cross_attn or --single_transformer layer has one kernel block, its
# self-attention: 8 launches a denoiser call, 400 a DDIM-50 call.
ABLATION_PER_CALL = 8
ABLATION_LAUNCHES_PER_CALL = ABLATION_PER_CALL * DDIM_STEPS
# serving run → (ModelConfig fields, T, the form its attention blocks launch):
# --no_cross_attn fuses its self-attention (B1); a --single_transformer
# model's merged timeline never fuses, so --blocks fused takes B2 at 2T rows
# (182, and 392 at the evaluation length, past the 320 rows B2-bf16 holds
# whole)
ABLATION_SERVE_RUNS = {
    "no_cross_attn_fused": (dict(fused_blocks=True, interaction=False), T, "fused_block"),
    "single_transformer": (dict(fused_blocks=True, single_transformer=True), T,
                           "projected_attention"),
    "single_transformer_bf16": (dict(fused_blocks=True, single_transformer=True,
                                     compute_dtype="bfloat16"), EVAL_T,
                                "projected_attention_bf16"),
}
# training run → (extra arguments, steps, the form its blocks launch): 48
# clips, 2 passes, 3 batches of 32 pairs
ABLATION_TRAIN_RUNS = {
    "pit_no_cross_attn": (["--times", "2", "--no_cross_attn"], 3, "projected_attention"),
    "pit_single_transformer_bf16": (["--times", "2", "--single_transformer", "--compute_dtype",
                                     "bfloat16"], 3, "efficient_attention_bf16"),
}
# train_single: t2m widths (263 features, 22 joints), SINGLE_CLIPS whole
# clips of 70 to 199 rows, 2 passes: 3 batches of 32 at the 60-frame window;
# then one DDIM-50 sampler call of 8 captions at the dataset's 196 frames
SINGLE_CLIPS, SINGLE_STEPS = 48, 3
# B2-bf16 past 320 rows: (sequences, caption pairs merged end to end at
# EVAL_T each)
B2_LONG_SHAPES = {"16x392": 16, "104x392": 2 * EVAL_CLIPS}


def merged_inputs(device, sequences: int):
    """``block_inputs`` at EVAL_T with each pair's two actors put end to end:
    (sequences, 2 EVAL_T, D) rows and their mask, as a --single_transformer
    model's self-attention sees them."""
    w, x, mask, _, _ = block_inputs(device, sequences, EVAL_T)
    return w, x.reshape(sequences, 2 * EVAL_T, D), mask.reshape(sequences, 2 * EVAL_T)


def check_projected_attention_bf16_long(device, failures) -> dict:
    """B2-bf16 at 392 rows (a --single_transformer model's merged timeline at
    the evaluation length) against its twin beside the planted control (the
    twin with B1-bf16's core roundings), timed, with its bound, at
    B2_LONG_SHAPES."""
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain

    hd, rows = D // HEADS, {}
    for name, sequences in B2_LONG_SHAPES.items():
        w, x, mask = merged_inputs(device, sequences)
        xn = to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
        ws = [to_bf16(t) for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
        args = (xn, xn, *ws, HEADS, mask)
        twin = plain(*args)
        twin32 = plain(xn.float(), xn.float(), *[t.float() for t in ws], HEADS, mask)
        twin_cpu = plain(*on_cpu(args))
        label = f"projected_attention_bf16 {name}"
        row = gate_bf16(label, fused_projected_attention(*args), twin, twin32, twin_cpu,
                        failures)
        control = bf16_gate_row(plain(*args, rounded=B1_CORE_ROUNDINGS), twin, twin32, twin_cpu)
        fail_if(failures, control["passed"],
                f"{label}: the twin with B1's core roundings passes: {control}")
        row["control_rms_ratio"] = control["rms_ratio"]
        row["ms"] = time_ms(lambda: fused_projected_attention(*args))
        row["plain_ms"] = time_ms(lambda: plain(*args))
        N, Tq = x.shape[:2]
        M = N * Tq
        parts = [(2 * M * D * 3 * D, "bf16"), (2 * 2 * N * HEADS * Tq * hd * hd, "3xtf32")]
        row["bound_ms"], row["bound_by"], row["bound_kind"] = bound_parts(
            parts, 2 * (3 * M * D + 3 * D * D + 3 * D) + 4 * M)
        rows[name] = row
        del args, twin, twin32, twin_cpu
    print(json.dumps({"phase": "ablations", "kernel": "projected_attention_bf16",
                      "rows_392": rows}), flush=True)
    return {"rows_392": rows}


def write_single_data(root: str, seed: int = 0) -> None:
    """A seeded t2m-format dataset: SINGLE_CLIPS clips of 70 to 199 rows (the
    init row last) of random 263-d features, one whole-clip caption each
    from the caption table, train.txt, Mean.npy / Std.npy of 266 entries."""
    from hig_tpu_torch.data.vocab import CAPS

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names = []
    for i in range(SINGLE_CLIPS):
        name = f"S{i:03d}"
        motion = rng.standard_normal((int(rng.integers(70, 200)), 263), dtype=np.float32)
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"), motion)
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write(f"{CAPS[i % len(CAPS)]}#none#0.0#0.0\n")
        names.append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    np.save(os.path.join(root, "Mean.npy"), np.zeros(266, np.float32))
    np.save(os.path.join(root, "Std.npy"), np.ones(266, np.float32))


def ablation_serve(device, failures, smi: str) -> dict:
    """8 requests served, DDIM-50, through each ABLATION_SERVE_RUNS model
    (seeded weights), graphed against the eager loop as in phase 5 (2
    timed replays, 1 eager call) with exact launch counts; a float32 run held to the plain route at
    SAMPLER_REL_TOL, the bfloat16 one to BF16_ROUTE_RMS of the bfloat16
    effect as phase 10's serving runs are (its relative error reported).
    Returns the launch counts."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import ModelConfig
    from hig_tpu_torch.train.trainer import make_sampler

    sched = g.make_schedule(g.linear_betas(1000))
    launches: dict = {}
    for run, (fields, t_run, own) in ABLATION_SERVE_RUNS.items():
        t0 = time.perf_counter()
        requests = [dict(r, length=r["length"] * (t_run - 1) // (T - 1))
                    for r in serve_requests()]
        model = serve.build_model(ModelConfig(**fields), device, random_init=0)
        mean, std = serve.load_stats(None, model.cfg.input_feats)
        kw = dict(T=t_run, dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS)
        sample_fn = make_sampler(model, sched, **kw)
        call = serve_with(sample_fn, requests, mean, std)
        eager = serve_with(make_sampler(model, sched, graph=False, **kw), requests, mean, std)
        row, (features, joints), first, call_counts = graph_and_eager(
            f"ablation serve ({run})", call, eager, sample_fn.graphs, failures, replays=2,
            eager_calls=1)
        with plain_blocks():
            p16, _ = eager(torch.Generator(device=device).manual_seed(0))
        rel = float(np.abs(features - p16).max() / np.abs(p16).max())
        row.update(rel_err_vs_plain=rel, rel_tol=SAMPLER_REL_TOL)
        if model.cfg.dtype == torch.bfloat16:
            twin = f32_twin_model(model)
            twin_fn = make_sampler(twin, sched, graph=False, **kw)
            with plain_blocks():
                p32, _ = serve.serve_batch(twin_fn, requests, mean, std, device,
                                           torch.Generator(device=device).manual_seed(0))
            del twin, twin_fn
            row.update(route_gate(f"ablation serve ({run})", features, p16, p32, failures))
        else:
            fail_if(failures, not rel <= SAMPLER_REL_TOL,
                    f"ablation serve ({run}): rel err {rel} against the plain route")
        print(json.dumps({"phase": "ablations", "run": f"serve_{run}", "nvidia_smi": smi,
                          "requests": len(requests), "T": t_run, "rows": 2 * t_run if
                          model.cfg.single_transformer else t_run, "ddim_steps": DDIM_STEPS,
                          "launches": call_counts[0], **row,
                          "finite": bool(np.isfinite(features).all()
                                         and np.isfinite(joints).all()),
                          "joints_shape": list(joints.shape),
                          "seconds": time.perf_counter() - t0}), flush=True)
        fail_if(failures, any(c[name] != (ABLATION_LAUNCHES_PER_CALL if name == own else 0)
                              for c in call_counts for name in c)
                or any(first[name] != (ABLATION_LAUNCHES_PER_CALL + ABLATION_PER_CALL
                                       if name == own else 0) for name in first),
                f"ablation serve ({run}) launches {first}, {call_counts}")
        fail_if(failures, tuple(joints.shape) != (N_PAIRS, 2, t_run - 1, 22, 3)
                or not np.isfinite(joints).all(),
                f"ablation serve ({run}) joints {joints.shape}")
        for name, n in first.items():
            launches[name] = launches.get(name, 0) + n
        if run == "single_transformer":
            launches = merge_counts(launches, ablation_vote(model, sched, device, failures))
        del model, sample_fn
    return launches


def merge_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}


def ablation_vote(model, sched, device, failures) -> dict:
    """One labeling vote (the scorer's forward over LABEL_BATCH pairs under
    both caption assignments) of a --single_transformer model: 8 B2
    launches at 182 rows, against the plain route (DENOISER_TOL of the
    largest summed loss). Returns its launch counts."""
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train import labeling

    gen = torch.Generator().manual_seed(4)
    encode, score = labeling.make_assignment_scorer(model, sched)
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64))
    cond = tokens[torch.randint(0, len(CAPS), (LABEL_BATCH, 2), generator=gen)].to(device)
    motion = torch.randn((LABEL_BATCH, 2, T, model.cfg.input_feats), generator=gen).to(device)
    lengths = (torch.tensor(LENGTHS * (LABEL_BATCH // N_PAIRS)) + 1).to(device)
    noise = torch.randn(motion.shape, generator=gen).to(device)
    t_vote = labeling.LABEL_T_VALUES[0]
    xf_proj, xf_out = encode(cond, cond.flip(1))
    reset_counts()
    got = score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)
    torch.cuda.synchronize()
    counts = bf16_counts()
    with plain_blocks():
        want = score(motion, lengths, xf_proj, xf_out, t_vote, noise=noise)
    rel = float((got - want).abs().max() / want.abs().max())
    print(json.dumps({"phase": "ablations", "run": "label_vote_single_transformer",
                      "pairs": LABEL_BATCH, "rows": 2 * T, "t": t_vote, "launches": counts,
                      "rel_err": rel, "rel_tol": DENOISER_TOL,
                      "votes_differing": int((got.argmin(1) != want.argmin(1)).sum())}),
          flush=True)
    fail_if(failures, not rel <= DENOISER_TOL, f"single_transformer vote: rel err {rel}")
    fail_if(failures, any(n != (ABLATION_PER_CALL if k == "projected_attention" else 0)
                          for k, n in counts.items()),
            f"single_transformer vote launches {counts}")
    return counts


def ablation_train(device, failures, smi: str, data: str, tmp: str) -> dict:
    """ABLATION_TRAIN_RUNS through ``python -m hig_tpu_torch.train``'s main
    on phase 6's dataset, each graphed and eagerly from the same seed (bit
    for bit, ``graphed_and_eager_run``; 8 launches a step of the run's own
    form), and one batch's loss and gradients at the run's initial weights
    against the plain route: float32 at phase 6's tolerances
    (``grad_route_errors``), bfloat16 at the first layer within
    BF16_TRAIN_RMS of the bfloat16 effect beside phase 11's control
    (``bf16_grad_gate``). Returns the launch counts, the ordered bfloat16
    sum's under BF16_SUM."""
    launches: dict = {}
    for run, (extra, steps, own) in ABLATION_TRAIN_RUNS.items():
        trainer, state, row, counts = graphed_and_eager_run(
            run, extra, steps, own, data, tmp, failures, smi, per_step=ABLATION_PER_CALL)
        batch, initial = first_batch(trainer)
        if trainer.model_config.compute_dtype == "bfloat16":
            row["grad_gate"] = bf16_grad_gate(trainer.sched, batch, initial, run, failures)
        else:
            row["grad_check"] = grad_route_errors(initial, trainer.sched, batch, pit=True)
            gate_grad_check(failures, run, "grad_check", row["grad_check"])
        del initial, batch, trainer, state
        print(json.dumps({**row, "phase": "ablations"}), flush=True)
        launches = merge_counts(launches, counts)
    return launches


def ablation_train_single(device, failures, smi: str, tmp: str) -> dict:
    """``python -m hig_tpu_torch.train_single``'s main at full width on a
    seeded t2m-format dataset, SINGLE_STEPS steps graphed and eagerly (the
    final parameters, Adam moments and metrics bit for bit, 8 B2 launches a
    step), then ``make_single_sampler`` DDIM-50 on the trained model:
    graphed (the capture and a replay) against the eager loop bit for bit,
    and the eager loop against the plain route at SAMPLER_REL_TOL. Returns
    the launch counts."""
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train.trainer import make_single_sampler
    from hig_tpu_torch.train_single import main as single_main

    data = os.path.join(tmp, "single_data")
    write_single_data(data)
    launches: dict = {}
    states, metrics, rows = [], [], []
    for graph in (True, False):
        name = "single" if graph else "single_eager"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = single_main(["--name", name, "--dataset_name", "t2m", "--data_root", data,
                             "--checkpoints_dir", os.path.join(tmp, "runs"), "--batch_size",
                             str(TRAIN_PAIRS), "--num_epochs", "1", "--times", "2",
                             "--log_every", "1", "--seed", "0"], graph=graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = bf16_counts()
        with open(os.path.join(tmp, "runs", "t2m", name, "metrics.jsonl")) as f:
            metrics.append([json.loads(line) for line in f])
        states.append(state)
        rows.append({"graph": graph, "steps": state.step, "launches": counts, "wall_s": wall,
                     "losses": [m["loss_mot_rec"] for m in metrics[-1]]})
        fail_if(failures, state.step != SINGLE_STEPS
                or any(n != (ABLATION_PER_CALL * SINGLE_STEPS if k == "projected_attention"
                             else 0) for k, n in counts.items())
                or not all(np.isfinite(rows[-1]["losses"])),
                f"train_single ({name}): {rows[-1]}")
        launches = merge_counts(launches, counts)
    got, want = final_state_tensors(states[0]), final_state_tensors(states[1])
    differ = [n for n in want if not torch.equal(got[n], want[n])]
    fail_if(failures, bool(differ) or metrics[0] != metrics[1] or got.keys() != want.keys(),
            f"train_single: the graphed run differs from the eager run: {differ}")

    model = states[0].model.eval()
    sched = g.make_schedule(g.linear_betas(1000))
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64)[np.arange(N_PAIRS) * 5 % 43])
    lengths = torch.tensor([L * (EVAL_T - 1) // (T - 1) + 1 for L in LENGTHS])
    kw = dict(T=EVAL_T, dim_pose=263, sampler="ddim", ddim_steps=DDIM_STEPS)
    graphed = make_single_sampler(model, sched, **kw)
    eager = make_single_sampler(model, sched, graph=False, **kw)
    noise = torch.randn((N_PAIRS, EVAL_T, 263), generator=torch.Generator().manual_seed(6))
    calls = []
    for fn in (graphed, graphed, eager):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(tokens, lengths, noise=noise.to(device))
        torch.cuda.synchronize()
        calls.append((out, time.perf_counter() - t0, bf16_counts()))
    with plain_blocks():
        ref = eager(tokens, lengths, noise=noise.to(device))
    same = all(torch.equal(calls[0][0], c[0]) for c in calls[1:])
    rel = float((calls[2][0] - ref).abs().max() / ref.abs().max())
    sample_row = {"T": EVAL_T, "captions": N_PAIRS, "ddim_steps": DDIM_STEPS,
                  "capture": next(iter(graphed.graphs.values())).summary(),
                  "wall_s": [c[1] for c in calls], "launches": [c[2] for c in calls],
                  "graph_equals_eager": same, "rel_err_vs_plain": rel,
                  "rel_tol": SAMPLER_REL_TOL, "finite": bool(torch.isfinite(ref).all())}
    print(json.dumps({"phase": "ablations", "run": "train_single", "nvidia_smi": smi,
                      "pairs_per_step": TRAIN_PAIRS, "window": 60, "runs": rows,
                      "graph_equals_eager": not differ and metrics[0] == metrics[1],
                      "sampler": sample_row}), flush=True)
    fail_if(failures, not same or not rel <= SAMPLER_REL_TOL
            or tuple(calls[0][0].shape) != (N_PAIRS, EVAL_T, 263),
            f"train_single sampler: {sample_row}")
    want_counts = [ABLATION_LAUNCHES_PER_CALL + ABLATION_PER_CALL, ABLATION_LAUNCHES_PER_CALL,
                   ABLATION_LAUNCHES_PER_CALL]
    fail_if(failures, any(c[2][k] != (n if k == "projected_attention" else 0)
                          for c, n in zip(calls, want_counts) for k in c[2]),
            f"train_single sampler launches {[c[2] for c in calls]}")
    return merge_counts(launches, calls[0][2])


def phase_ablations(device, failures, smi: str, data: str, tmp: str) -> tuple[dict, dict]:
    """Phase 12 (see the module doc). Returns (the launch counts of its
    runs by form, B2-bf16's rows past 320 rows)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernel = check_projected_attention_bf16_long(device, failures)
    launches = ablation_serve(device, failures, smi)
    launches = merge_counts(launches, ablation_train(device, failures, smi, data, tmp))
    launches = merge_counts(launches, ablation_train_single(device, failures, smi, tmp))
    print(json.dumps({"phase": "ablations", "launches": launches,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches, kernel


# Phase 13: the single-chip options. The causal efficient model runs no
# kernel (JAX's causal blocks take their einsum route), so its runs launch
# nothing but the ordered bfloat16 sum of a bfloat16 step's softmax
# backwards.
CAUSAL_SERVE_RUNS = {"f32": "float32", "bf16": "bfloat16"}
# step run → (ExperimentConfig fields, the form its blocks launch): PIT at
# batch 32, OPTION_STEPS steps graphed and eagerly from one state
OPTION_STEP_RUNS = {
    "pit_causal": (dict(causal=True), None),
    "pit_causal_bf16": (dict(causal=True, compute_dtype="bfloat16"), None),
    "pit_native_w60": (dict(use_native_loader=True, window_size=60), "projected_attention"),
}
OPTION_STEPS = 3
NATIVE_WINDOW = 60
LOADER_TIMES = 4  # the loader timing's epoch: 48 clips, 4 passes, 6 batches of 32
# The reference's CLIP text tower (ViT-B/32) and learnable text stack, as
# its state dict names them


def model_from(cfg, weights: dict, device):
    """An InteractionModel of ``cfg`` on ``device`` holding copies of
    ``weights`` (a state dict), built on the meta device: no init of its
    own to pay for at full width."""
    from hig_tpu_torch.models.interaction_model import InteractionModel

    with torch.device("meta"):
        model = InteractionModel(cfg)
    model.load_state_dict({k: v.to(device, copy=True) for k, v in weights.items()},
                          strict=True, assign=True)
    return model


def causal_denoiser_check(model, device, failures, label: str) -> dict:
    """One full-width denoiser call of the causal model on 8 pairs: float32
    against the same call in float64 on the card (DENOISER_TOL of the
    largest magnitude); bfloat16 cut to its first layer against the same
    cut on the CPU (the XLA-order twin the CPU tests hold to JAX), within
    BF16_ROUTE_RMS of the bfloat16 effect (that twin against the float32
    cut on the same weights)."""
    gen = torch.Generator().manual_seed(2)
    cfg = model.cfg
    x = torch.randn((N_PAIRS, 2, T, cfg.input_feats), generator=gen)
    t = torch.full((N_PAIRS,), 500)
    lengths = torch.tensor(LENGTHS) + 1
    xf_proj = torch.randn((N_PAIRS, 2, cfg.time_embed_dim), generator=gen)
    xf_out = torch.randn((N_PAIRS, 2, 77, cfg.text_latent_dim), generator=gen)

    def run(m, dev, dt):
        # the motion input is float32 until the first Linear, but in float64
        with torch.no_grad():
            x_dt = torch.float64 if dt == torch.float64 else torch.float32
            return m.denoise(x.to(dev, x_dt),
                             t.to(dev), lengths.to(dev), xf_proj.to(dev, dt),
                             xf_out.to(dev, dt)).double().cpu()

    if cfg.dtype == torch.float32:
        got = run(model, device, torch.float32)
        model64 = copy.deepcopy(model).double()
        want = run(model64, device, torch.float64)
        del model64
        rel = float((got - want).abs().max() / want.abs().max())
        fail_if(failures, not rel <= DENOISER_TOL, f"{label}: rel err {rel} against float64")
        return {"rel_err_vs_float64": rel, "tol": DENOISER_TOL}
    cut = first_layer(model)
    got = run(cut, device, torch.bfloat16)
    twin = run(copy.deepcopy(cut).cpu(), "cpu", torch.bfloat16)
    twin32 = run(f32_twin_model(cut).cpu(), "cpu", torch.float32)
    return {"first_layer": route_gate(f"{label} first layer", got.numpy(), twin.numpy(),
                                      twin32.numpy(), failures)}


def causal_serve(device, failures, smi: str, weights: dict) -> dict:
    """(a) 8 requests served, DDIM-50, by the causal efficient model (phase
    4's seeded ``weights``, --blocks fused, which a causal block ignores) in float32 and
    bfloat16, graphed against the eager loop as in phase 5 (2 replays, 1
    eager call), no launch of any kernel, with ``causal_denoiser_check``.
    Returns {"causal_serve_<run>": (call, wall s)} for the profile."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import ModelConfig
    from hig_tpu_torch.train.trainer import make_sampler

    sched = g.make_schedule(g.linear_betas(1000))
    runs = {}
    for run, dtype in CAUSAL_SERVE_RUNS.items():
        t0 = time.perf_counter()
        model = model_from(ModelConfig(causal=True, fused_blocks=True, compute_dtype=dtype),
                           weights, device).eval()
        mean, std = serve.load_stats(None, model.cfg.input_feats)
        kw = dict(T=T, dim_pose=model.cfg.input_feats, ddim_steps=DDIM_STEPS)
        sample_fn = make_sampler(model, sched, **kw)
        call = serve_with(sample_fn, serve_requests(), mean, std)
        eager = serve_with(make_sampler(model, sched, graph=False, **kw), serve_requests(),
                           mean, std)
        row, (features, joints), first, call_counts = graph_and_eager(
            f"causal serve ({run})", call, eager, sample_fn.graphs, failures, replays=2,
            eager_calls=1)
        row.update(causal_denoiser_check(model, device, failures, f"causal serve ({run})"))
        print(json.dumps({"phase": "options", "run": f"serve_causal_{run}", "nvidia_smi": smi,
                          "requests": N_PAIRS, "T": T, "ddim_steps": DDIM_STEPS,
                          "launches": call_counts[0], **row,
                          "finite": bool(np.isfinite(features).all()
                                         and np.isfinite(joints).all()),
                          "joints_shape": list(joints.shape),
                          "seconds": time.perf_counter() - t0}), flush=True)
        fail_if(failures, any(n for c in [first, *call_counts] for n in c.values()),
                f"causal serve ({run}) launched a kernel: {first}, {call_counts}")
        fail_if(failures, tuple(joints.shape) != (N_PAIRS, 2, T - 1, 22, 3)
                or not np.isfinite(joints).all(), f"causal serve ({run}) joints {joints.shape}")
        runs[f"causal_serve_{run}"] = (seeded(call), row["wall_s_per_call"])
        del model, sample_fn
    return runs


def loader_rates(data: str, tmp: str, failures) -> dict:
    """(c) One epoch (LOADER_TIMES passes over phase 6's clips, batches of
    32) through the Python loader and through the native one, batches/s of
    each (the native one's first call builds its store), and one native
    batch from 1 and from 8 threads, equal bit for bit."""
    from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths
    from hig_tpu_torch.data.native_loader import store_from_dataset
    from hig_tpu_torch.train.trainer import Trainer

    out = {}
    for native in (False, True):
        cfg = add_dataset_paths(ExperimentConfig(
            data_root=data, batch_size=TRAIN_PAIRS, times=LOADER_TIMES,
            use_native_loader=native, window_size=NATIVE_WINDOW,
            checkpoints_dir=os.path.join(tmp, "runs")))
        dataset = trainer_dataset(cfg)
        batches = Trainer(cfg, "cpu").epoch_batches_fn(dataset, {}, log=lambda _: None)
        t0 = time.perf_counter()
        shapes = [b["motion"].shape for b in batches(0)]
        wall = time.perf_counter() - t0
        out["native" if native else "python"] = {
            "batches": len(shapes), "batches_per_s": len(shapes) / wall, "wall_s": wall,
            "T": shapes[0][2]}
    store, swaps = store_from_dataset(dataset)
    idx = np.arange(TRAIN_PAIRS) % len(store)
    one, eight = (store.sample_batch(idx, window=NATIVE_WINDOW, seed=0, epoch=0,
                                     swap_flags=swaps[idx], num_threads=n) for n in (1, 8))
    out["threads_1_equal_8"] = all(np.array_equal(a, b) for a, b in zip(one, eight))
    fail_if(failures, not out["threads_1_equal_8"], "native loader: 1 and 8 threads differ")
    fail_if(failures, out["python"]["T"] != T or out["native"]["T"] != NATIVE_WINDOW + 1
            or out["python"]["batches"] != out["native"]["batches"],
            f"loaders: {out}")
    return out


def option_steps(device, failures, smi: str, data: str, weights: dict) -> dict:
    """(b) and (c): each OPTION_STEP_RUNS run's first OPTION_STEPS batches of
    phase 6's clips (2 passes) from the trainer's own batch path (the
    native loader at window 60: T = 61, its own capture) through
    ``make_train_step``, graphed (the first step eager, the capture, then
    replays) and eagerly from one seeded state (phase 4's ``weights``, which
    are ``Trainer.init_state``'s of seed 0) with the trainer's per-step
    generators: metrics, parameters and Adam's moments bit for bit, no
    kernel launch on the causal route (the ordered bfloat16 sum in
    bfloat16), 16 B2 launches a step on the native one; step ms, peak
    memory and the graph's pool. Returns the launch counts."""
    from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths
    from hig_tpu_torch.ops.bf16_sum import bf16_sum
    from hig_tpu_torch.train import trainer as tr

    launches: dict = {}
    for run, (fields, own) in OPTION_STEP_RUNS.items():
        t0 = time.perf_counter()
        cfg = add_dataset_paths(ExperimentConfig(data_root=data, batch_size=TRAIN_PAIRS,
                                                 times=2, **fields))
        trainer = tr.Trainer(cfg, device)
        states = []
        for _ in range(2):
            model = model_from(trainer.model_config, weights, device).train()
            states.append(tr.TrainState(model=model, optimizer=tr.make_optimizer(cfg, model)))
        tower = trainer.precompute_tower(states[0].model)
        batches = trainer.epoch_batches_fn(trainer_dataset(cfg), {}, log=lambda _: None)(0)
        batches = [trainer._device_batch(next(batches), tower) for _ in range(OPTION_STEPS)]
        row = {"phase": "options", "run": run, "nvidia_smi": smi,
               "pairs_per_step": TRAIN_PAIRS, "T": batches[0]["motion"].shape[2]}
        finals = []
        for graph, state in zip((True, False), states):
            step = tr.make_train_step(trainer.sched, True, graph=graph)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics, ms = [], []
            for it, batch in enumerate(batches):
                t_step = time.perf_counter()
                out = step(state, batch, tr.step_generator(cfg.seed + 1, it, 0, device))
                metrics.append(torch.stack([out[k] for k in tr.TRAIN_METRICS]).tolist())
                ms.append(1e3 * (time.perf_counter() - t_step))
            counts = {**bf16_counts(), BF16_SUM: bf16_sum.launches}
            key = "graphed" if graph else "eager"
            row[key] = {"step_ms": ms, "median_ms_after_first": statistics.median(ms[1:]),
                        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": counts, "losses": [m[0] for m in metrics]}
            if graph:
                (capture,) = [c.summary() for c in step.graphs.values()]
                row[key]["capture"] = {k: capture[k] for k in ("warmup_s", "capture_s")} | {
                    "pool_gb": capture["pool_bytes"] / 1e9}
                row["pairs_per_s"] = TRAIN_PAIRS * 1e3 / row[key]["median_ms_after_first"]
            finals.append((metrics, final_state_tensors(state), counts))
            del step
        (m_g, t_g, c_g), (m_e, t_e, c_e) = finals
        differ = [n for n in t_e if not torch.equal(t_g[n], t_e[n])]
        row["graph_equals_eager"] = not differ and m_g == m_e and c_g == c_e
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        fail_if(failures, not row["graph_equals_eager"],
                f"steps ({run}): graphed differs from eager: {differ[:4]}, {m_g} vs {m_e}")
        fail_if(failures, any(n != (LAUNCHES_PER_STEP * OPTION_STEPS if k == own else 0)
                              for k, n in c_g.items() if k != BF16_SUM)
                or (c_g[BF16_SUM] > 0) != (cfg.compute_dtype == "bfloat16"),
                f"steps ({run}) launches {c_g}")
        fail_if(failures, not np.isfinite(m_g).all(), f"steps ({run}) metrics {m_g}")
        fail_if(failures, row["T"] != (NATIVE_WINDOW + 1 if cfg.use_native_loader else T),
                f"steps ({run}): T {row['T']}")
        launches = merge_counts(launches, c_g)
        del trainer, states, model, batches, finals
    return launches


def pretrained_load(failures, data: str, tmp: str) -> dict:
    """(d) A full-width reference state dict (``reference_state_dict``, saved
    as the reference's {"encoder": ...} latest.tar) loaded by ``python -m
    hig_tpu_torch.train --pretrained`` (no step: 0 epochs): every converted
    leaf on the card equal to the dict's, every other parameter at its
    seeded value."""
    from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, model_config
    from hig_tpu_torch.train import torch_port
    from hig_tpu_torch.train.__main__ import main as train_main
    from hig_tpu_torch.weights import torch_state_from_flax

    t0 = time.perf_counter()
    cfg = add_dataset_paths(ExperimentConfig(data_root=data))
    sd = torch_port.reference_state_dict(model_config(cfg))
    path = os.path.join(tmp, "reference_latest.tar")
    torch_port.save_reference_checkpoint(sd, path)
    trainer, state = train_main(["--name", "pretrained", "--data_root", data,
                                 "--checkpoints_dir", os.path.join(tmp, "runs"),
                                 "--batch_size", str(TRAIN_PAIRS), "--num_epochs", "0",
                                 "--pretrained", "--pretrained_path", path])
    want = torch_state_from_flax(torch_port.convert_interaction_model(sd))
    params = dict(state.model.named_parameters())
    differ = [n for n, w in want.items() if not torch.equal(params[n].cpu(), w)]
    row = {"phase": "options", "run": "pretrained", "reference_tensors": len(sd),
           "reference_params": int(sum(v.size for v in sd.values())),
           "converted_leaves": len(want), "model_leaves": len(params),
           "on_device": str(params["denoiser.out.weight"].device), "differ": differ,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    fail_if(failures, bool(differ) or len(want) != len(params) or state.step != 0,
            f"pretrained: {row}")
    del trainer, state, sd
    return row


PARITY_LENGTH = 60  # parity_smoke's --motion_length (its default): T = 61


def asset_tools(failures, smi: str, tmp: str) -> dict:
    """(f) ``python -m hig_tpu_torch.parity_smoke`` on (d)'s full-width
    reference state dict (DDIM-50 sampling; every leaf from the dict), its
    probe's output on the card against the same model's on the CPU within
    DENOISER_TOL of its largest magnitude, the launches (the probe's
    forward and the capturing sampler call through B2), a finite decoded
    sample; ``python -m hig_tpu_torch.check_assets`` with no asset present."""
    from hig_tpu_torch import check_assets, parity_smoke

    meta = os.path.join(tmp, "parity_meta")
    os.makedirs(meta, exist_ok=True)
    np.save(os.path.join(meta, "mean.npy"), np.zeros(267, np.float32))
    np.save(os.path.join(meta, "std.npy"), np.ones(267, np.float32))
    ref = os.path.join(tmp, "reference_latest.tar")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parity_smoke.main(["--checkpoint", ref, "--mean", os.path.join(meta, "mean.npy"),
                             "--std", os.path.join(meta, "std.npy"), "--sampler", "ddim",
                             "--motion_length", str(PARITY_LENGTH), "--out",
                             os.path.join(tmp, "parity")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in bf16_counts().items() if v}
    t1 = time.perf_counter()
    model = copy.deepcopy(out.pop("model")).cpu()  # the same weights on the CPU
    twin = parity_smoke.probe(model, 2, PARITY_LENGTH + 1)
    twin_s = time.perf_counter() - t1
    del model
    err = float(np.abs(out["probe"] - twin).max() / np.abs(twin).max())
    joints = np.load(out["sample"])
    row = {"phase": "options", "run": "parity_smoke", "nvidia_smi": smi, "wall_s": wall,
           "cpu_twin_s": twin_s, "coverage": list(out["coverage"]),
           "probe": parity_smoke.probe_stats(out["probe"]),
           "cpu_probe": parity_smoke.probe_stats(twin), "probe_rel_err": err,
           "tol": DENOISER_TOL, "launches": counts, "joints_shape": list(joints.shape),
           "graphs": [g.summary() for g in out["graphs"].values()]}
    want = {"projected_attention": LAUNCHES_PER_STEP + FIRST_CALL}
    fail_if(failures, not err <= DENOISER_TOL or out["coverage"][0] != out["coverage"][1]
            or counts != want or not np.isfinite(joints).all()
            or joints.shape != (2, PARITY_LENGTH, 22, 3), f"parity_smoke: {row}, launches "
            f"expected {want}")
    print(json.dumps(row), flush=True)
    reset_counts()
    report = check_assets.main(["--assets_dir", os.path.join(tmp, "no_assets"), "--data_root",
                                os.path.join(tmp, "no_data"), "--reference_ckpt",
                                os.path.join(tmp, "no_checkpoint.tar")])
    rows = [{"asset": a, "present": p is not None, "status": st} for a, p, st in report]
    print(json.dumps({"phase": "options", "run": "check_assets", "rows": rows}), flush=True)
    fail_if(failures, len(rows) != 8 or any(r["present"] for r in rows)
            or any(bf16_counts().values()), f"check_assets: {rows}")
    return row


def graft_run(device, failures, smi: str, data: str, tmp: str) -> dict:
    """(e) ``python -m hig_tpu_torch.add_cfg_branch`` on phase 6's
    supervised checkpoint (trained without caption dropout): 8 requests
    served, DDIM-50 unguided, from the donor and from the graft equal bit
    for bit (B1, a capturing call each); then ``train --is_continue
    --cond_drop_prob 0.1`` from the graft for one step (16 B2 launches).
    Returns the launch counts."""
    from hig_tpu_torch import add_cfg_branch, serve
    from hig_tpu_torch.config import load_opt_txt, model_config
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import checkpoint as ckpt
    from hig_tpu_torch.train.__main__ import main as train_main
    from hig_tpu_torch.train.trainer import eval_params, make_sampler

    t0 = time.perf_counter()
    donor = load_opt_txt(os.path.join(tmp, "runs", "ntu_mul", "supervised", "opt.txt"))
    new = add_cfg_branch.main(["--opt_path", os.path.join(donor.save_root, "opt.txt"),
                               "--name", "graft_cfg", "--cond_drop_prob", "0.1"])
    sched = g.make_schedule(g.linear_betas(1000))
    outs, launches = [], {}
    for cfg in (donor, new):
        payload = ckpt.load(os.path.join(cfg.model_dir, "latest.pt"))
        model = model_from(dataclasses.replace(model_config(cfg), fused_blocks=True),
                           eval_params(payload), device).eval()
        mean, std = serve.load_stats(cfg.meta_dir, model.cfg.input_feats)
        sample_fn = make_sampler(model, sched, T=T, dim_pose=model.cfg.input_feats,
                                 ddim_steps=DDIM_STEPS)
        reset_counts()
        outs.append(serve_with(sample_fn, serve_requests(), mean, std)(
            torch.Generator(device=device).manual_seed(0)))
        launches = merge_counts(launches, bf16_counts())
        del model, sample_fn
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    reset_counts()
    # one more epoch after the graft's (the donor's), of one batch
    _, state = train_main(["--name", "graft_cfg", "--data_root", data, "--checkpoints_dir",
                           os.path.join(tmp, "runs"), "--batch_size", str(TRAIN_PAIRS),
                           "--num_epochs", str(payload["epoch"] + 1), "--times", "1",
                           "--limit_data_num", str(TRAIN_PAIRS), "--label_path",
                           os.path.join(data, "labels.json"), "--cond_drop_prob", "0.1",
                           "--is_continue", "--log_every", "1", "--seed", "0"])
    counts = bf16_counts()
    with open(os.path.join(new.save_root, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss_mot_rec"] for line in f]
    row = {"phase": "options", "run": "graft", "nvidia_smi": smi, "unguided_equal": same,
           "serve_launches": launches, "finetune_steps": state.step, "finetune_losses": losses,
           "finetune_launches": counts, "adam_count": state.optimizer.count,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    fail_if(failures, not same, "graft: unguided sampling differs from the donor's")
    fail_if(failures, launches.get("fused_block") != 2 * FIRST_CALL
            or counts.get("projected_attention") != LAUNCHES_PER_STEP
            or state.optimizer.count != 1 or len(losses) != 1
            or not np.isfinite(losses).all(), f"graft: {row}")
    return merge_counts(launches, counts)


def phase_options(device, failures, smi: str, data: str, tmp: str,
                  weights: dict) -> tuple[dict, dict]:
    """Phase 13 (see the module doc); ``weights``: phase 4's seeded fused
    model's state dict. Returns (the launch counts of its runs by form,
    {run: (call, wall s)} of the causal serving calls, profiled last)."""
    t_phase = time.perf_counter()
    runs = causal_serve(device, failures, smi, weights)
    launches = option_steps(device, failures, smi, data, weights)
    print(json.dumps({"phase": "options", "run": "loaders",
                      **loader_rates(data, tmp, failures)}), flush=True)
    pretrained_load(failures, data, tmp)
    launches = merge_counts(launches, asset_tools(failures, smi, tmp)["launches"])
    launches = merge_counts(launches, graft_run(device, failures, smi, data, tmp))
    print(json.dumps({"phase": "options", "launches": launches,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches, runs


# --- phase 14: the motion geometry, the data tools and visualization -------------------

# the port's synthetic dataset: GEO_CLIPS_PER_CLASS clips a class of 90 to
# 197 frames (four lengths), FK and encode on the card and on the CPU
GEO_CLIPS_PER_CLASS, GEO_FRAMES = 2, (90, 198)
GEO_PREPROCESS_CLIPS = 64  # generator pairs through python -m hig_tpu_torch.preprocess
GEO_FEAT_TOL = 1e-4  # the card's features against the CPU's (contacts: exactly)
GEO_ROUND_TRIP_TOL = 1e-3  # encode → recover_from_ric2 against the joints, m
GEO_STEPS, GEO_TIMES = 3, 3  # PIT steps from the port-made dataset (32 pairs each)
VIS_LENGTH = 90  # visualize --motion_length: T = 91, one DDIM-50 pair
# B3-bf16's forms side by side: (sequences, Tq, Tk) of the bf16 PIT step (32
# pairs under both assignments, 2 actors), the evaluation chunk, and a
# --single_transformer model's merged timeline at a native window of 196
B3_FORM_SHAPES = {"128x91": (2 * 2 * TRAIN_PAIRS, T, T),
                  "104x196": (2 * EVAL_CLIPS, EVAL_T, EVAL_T),
                  "64x394": (2 * TRAIN_PAIRS, 2 * (EVAL_T + 1), 2 * (EVAL_T + 1))}
ST_WINDOW, ST_PAIRS = 196, 4  # the bf16 --single_transformer step against its CPU twin


def dataset_diff(got: str, want: str) -> dict:
    """Two dataset roots: file names, texts and splits equal, the largest
    feature difference past the foot contacts, contacts that differ, and
    Mean/Std's largest difference."""
    names = sorted(os.listdir(os.path.join(want, "new_joint_vecs")))
    same_files = names == sorted(os.listdir(os.path.join(got, "new_joint_vecs")))
    feat, flips, entries = 0.0, 0, 0
    for name in names if same_files else []:
        a, b = (np.load(os.path.join(r, "new_joint_vecs", name)) for r in (got, want))
        feat = max(feat, float(np.abs(a[..., :-4] - b[..., :-4]).max()),
                   float(np.abs(a[:, -1] - b[:, -1]).max()))
        flips += int((a[:, :-1, -4:] != b[:, :-1, -4:]).sum())
        entries += a[:, :-1, -4:].size
    texts = sorted(os.listdir(os.path.join(want, "texts")))

    def same_bytes(rel):
        with open(os.path.join(got, rel), "rb") as f, open(os.path.join(want, rel), "rb") as g:
            return f.read() == g.read()

    return {"clips": len(names), "same_files": same_files, "max_feature_diff": feat,
            "contact_flips": flips, "contact_entries": entries,
            "same_texts": all(same_bytes(os.path.join("texts", t)) for t in texts),
            "same_splits": all(same_bytes(s) for s in ("train_sub.txt", "val_sub.txt",
                                                       "test_sub.txt")),
            "max_stats_diff": max(float(np.abs(np.load(os.path.join(got, s))
                                               - np.load(os.path.join(want, s))).max())
                                  for s in ("Mean.npy", "Std.npy"))}


def geometry_dataset(failures, tmp: str) -> tuple[str, dict]:
    """python -m hig_tpu_torch.make_synthetic_data on the card and with
    --device cpu, held against each other. Returns the card's root."""
    from hig_tpu_torch import make_synthetic_data

    argv = ["--clips_per_class", str(GEO_CLIPS_PER_CLASS), "--min_frames", str(GEO_FRAMES[0]),
            "--max_frames", str(GEO_FRAMES[1]), "--seed", "0"]
    roots, walls = {}, {}
    for where in ("cuda", "cpu"):
        roots[where] = os.path.join(tmp, f"geo_{where}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_synthetic_data.main(["--root", roots[where], "--device", where, *argv])
        torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
    diff = dataset_diff(roots["cuda"], roots["cpu"])
    row = {"wall_s": walls, **diff}
    fail_if(failures, not (diff["same_files"] and diff["same_texts"] and diff["same_splits"]
                           and diff["clips"] == GEO_CLIPS_PER_CLASS * 26),
            f"geometry: the card's dataset differs from the CPU's in its files {diff}")
    fail_if(failures, diff["max_feature_diff"] > GEO_FEAT_TOL or diff["contact_flips"]
            or diff["max_stats_diff"] > GEO_FEAT_TOL,
            f"geometry: the card's features against the CPU's {diff}")
    return roots["cuda"], row


def geometry_preprocess(failures, tmp: str) -> dict:
    """GEO_PREPROCESS_CLIPS generator pairs (FK on the card) written as
    joint clips, then python -m hig_tpu_torch.preprocess on the card: the
    encode rate beside the same encode on the CPU, the features against
    the CPU's, and encode → recover_from_ric2 against the joints."""
    from hig_tpu_torch import preprocess
    from hig_tpu_torch.data.synthetic import generate_pair
    from hig_tpu_torch.utils.motion_codec import recover_from_ric2

    rng = np.random.RandomState(1)
    joints_dir, out_root = os.path.join(tmp, "geo_joints"), os.path.join(tmp, "geo_pre")
    os.makedirs(joints_dir)
    clips = []
    for i in range(GEO_PREPROCESS_CLIPS):
        frames = int(rng.randint(GEO_FRAMES[0], GEO_FRAMES[1]))
        pair = generate_pair(rng, frames, i % 26, "cuda")
        clips.append(torch.stack(pair).cpu().numpy())
        np.save(os.path.join(joints_dir, f"P{i:03d}.npy"), clips[-1])
    t0 = time.perf_counter()
    preprocess.main(["--joints_dir", joints_dir, "--out_root", out_root])
    cli_wall = time.perf_counter() - t0
    feats = [np.load(os.path.join(out_root, "new_joint_vecs", f"P{i:03d}.npy"))
             for i in range(GEO_PREPROCESS_CLIPS)]
    rates = {}
    for where in ("cuda", "cpu", "cuda"):  # the card's again: its first call warms it
        got, timing = preprocess.encode_clips(clips, torch.device(where))
        rates[where] = timing["clips_per_s"]
        if where == "cpu":
            cpu_feats = got
    diff = max(float(np.abs(a - b).max()) for a, b in zip(feats, cpu_feats))
    flips = sum(int((a[:, :-1, -4:] != b[:, :-1, -4:]).sum()) for a, b in zip(feats, cpu_feats))
    trip = 0.0
    for joints, clip in zip(clips, feats):
        c = torch.from_numpy(clip).cuda()
        r1, r2 = recover_from_ric2(c[0], c[1], 22)
        j = torch.from_numpy(joints).cuda()
        floor = j[..., 1].amin()
        up = torch.tensor([0.0, 1.0, 0.0], device="cuda")
        want = j[:, :-1] - floor * up
        trip = max(trip, float((torch.stack([r1, r2]) - want).abs().max()))
    row = {"clips": GEO_PREPROCESS_CLIPS, "cli_wall_s": cli_wall,
           "encode_clips_per_s": rates, "max_feature_diff_vs_cpu": diff,
           "contact_flips_vs_cpu": flips, "round_trip_max_err_m": trip}
    fail_if(failures, diff > GEO_FEAT_TOL or flips, f"geometry: preprocess vs the CPU {row}")
    fail_if(failures, not trip <= GEO_ROUND_TRIP_TOL, f"geometry: round trip {row}")
    fail_if(failures, not os.path.exists(os.path.join(out_root, "Mean.npy")),
            "geometry: preprocess wrote no Mean.npy")
    return row


def geometry_visualize(failures, opt_path: str, tmp: str) -> tuple[dict, dict]:
    """python -m hig_tpu_torch.visualize from the PIT checkpoint, DDIM-50 at
    --motion_length VIS_LENGTH: its launch counts (the capturing call: 800
    B1 launches and the warm-up's 16, none of another form), its wall time,
    and its joints against serve's decode of the same graph replayed on the
    same seed, bit for bit. Returns (row, counts)."""
    from hig_tpu_torch import serve, visualize

    argv = ["--opt_path", opt_path, "--no-gif", "--motion_length", str(VIS_LENGTH),
            "--sampler", "ddim", "--ddim_steps", str(DDIM_STEPS), "--class_id", "3", "--seed",
            "0", "--result_path", os.path.join(tmp, "geo_vis")]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made = visualize.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bf16_counts()
    joints = np.load(made["path"])
    cond = serve.conditioning_for([dict(zip(("caption1", "caption2"), made["captions"]))])
    generator = torch.Generator(device="cuda").manual_seed(0)
    out = made["sample"](torch.from_numpy(cond), torch.tensor([VIS_LENGTH + 1]),
                         generator=generator)
    mean, std = serve.load_stats(os.path.join(os.path.dirname(opt_path), "meta"), 263)
    _, again = serve.decode(out, mean, std)
    row = {"wall_s": wall, "sampling_s": made["seconds"], "launches": counts,
           "joints_shape": list(joints.shape), "finite": bool(np.isfinite(joints).all()),
           "equals_serve_decode": bool(np.array_equal(joints, again[0].cpu().numpy()))}
    fail_if(failures, any(n != (FIRST_CALL if k == "fused_block" else 0)
                          for k, n in counts.items()), f"visualize launches {counts}")
    fail_if(failures, row["joints_shape"] != [2, VIS_LENGTH, 22, 3] or not row["finite"]
            or not row["equals_serve_decode"], f"visualize joints {row}")
    return row, counts


def b3_bf16_forms(device, failures) -> dict:
    """B3-bf16's whole and streaming forms at B3_FORM_SHAPES: each form's ms
    (the whole form where it runs), the plain twin's, the bound; at 394 rows
    the streaming form against its twin beside the planted controls; where
    both run, the two forms equal bit for bit."""
    from hig_tpu_torch.ops.pallas_attention import (
        BF16_MAX_T, efficient_attention_bf16_form, fused_efficient_attention_plain as plain)

    out = {}
    for label, (N, tq, tk) in B3_FORM_SHAPES.items():
        w, x, mask, _, _ = block_inputs(device, N // 2, max(tq, tk))
        q, k, v, heads, m = b3_bf16_inputs(w, x, mask, tk)
        q = q[..., :tq, :].contiguous()
        row = {"shape": [N, tq, tk, D]}
        forms = ("whole", "stream") if max(tq, tk) <= BF16_MAX_T else ("stream",)
        got = {}
        for form in forms:
            got[form] = efficient_attention_bf16_form(q, k, v, heads, m, form)
            row[f"{form}_ms"] = time_ms(lambda f=form: efficient_attention_bf16_form(
                q, k, v, heads, m, f))
        torch.cuda.synchronize()
        row["plain_ms"] = time_ms(lambda: plain(q, k, v, heads, m))
        parts, nbytes = b3_bf16_work(N, tq, tk)
        row["bound_ms"], row["bound_by"], _ = bound_parts(parts, nbytes)
        if len(forms) == 2:
            row["forms_equal"] = bool(torch.equal(got["whole"], got["stream"]))
            fail_if(failures, not row["forms_equal"], f"B3-bf16 forms differ at {label}")
        else:
            args = (q, k, v, heads, m)
            twin = plain(*args)
            twin32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
            twin_cpu = plain(*on_cpu(args))
            row.update(gate_bf16(f"efficient_attention_bf16 stream {label}", got["stream"],
                                 twin, twin32, twin_cpu, failures))
            controls = {}
            for left_out in B3_CORE_ROUNDINGS:
                c = bf16_gate_row(plain(*args, unrounded=(left_out,)), twin, twin32, twin_cpu)
                fail_if(failures, c["passed"], f"B3-bf16 stream {label}: the twin without "
                        f"{left_out} passes: {c}")
                controls[left_out] = c["rms_ratio"]
            row["controls_rms_ratio"] = controls
        out[label] = row
    return out


# B3-bf16's lazy forms (LAZY_KNORM): the whole and streaming forms at the
# training shape, the streaming form past 320 rows
B3_LAZY_SHAPES = {k: B3_FORM_SHAPES[k] for k in ("128x91", "64x394")}


def b3_lazy_forms(device, failures) -> dict:
    """B3-bf16's lazy forms at B3_LAZY_SHAPES against the lazy twin: each
    form's ms beside the eager form's (the whole form where it runs), the
    plain lazy twin's, the bound (the eager form's work); the kernel's
    elements that differ from the twin (bit for bit expected) and, at any
    rate, the gates of phase 10, beside the eager twin and the lazy twin
    without its state's roundings, which must fail them. Returns the row of
    ``efficient_attention_bf16_lazy`` for the kernel table (its launches
    phase 11's lazy step's)."""
    from hig_tpu_torch.ops.pallas_attention import (
        BF16_MAX_T, efficient_attention_bf16_form, fused_efficient_attention_plain as plain)

    out = {}
    for label, (N, tq, tk) in B3_LAZY_SHAPES.items():
        w, x, mask, _, _ = block_inputs(device, N // 2, max(tq, tk))
        q, k, v, heads, m = b3_bf16_inputs(w, x, mask, tk)
        args = (q[..., :tq, :].contiguous(), k, v, heads, m)
        row = {"shape": [N, tq, tk, D]}
        forms = ("whole", "stream") if max(tq, tk) <= BF16_MAX_T else ("stream",)
        got = {}
        for form in forms:
            got[form] = efficient_attention_bf16_form(*args, form, lazy=True)
            row[f"{form}_ms"] = time_ms(lambda f=form: efficient_attention_bf16_form(
                *args, f, lazy=True))
            row[f"eager_{form}_ms"] = time_ms(lambda f=form: efficient_attention_bf16_form(
                *args, f))
        torch.cuda.synchronize()
        row["plain_ms"] = time_ms(lambda: plain(*args, lazy=True))
        parts, nbytes = b3_bf16_work(N, tq, tk)
        row["bound_ms"], row["bound_by"], _ = bound_parts(parts, nbytes)
        twin = plain(*args, lazy=True)
        twin32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args], lazy=True)
        twin_cpu = plain(*on_cpu(args), lazy=True)
        for form in forms:
            row[f"{form}_differ"] = int((got[form] != twin).sum())
            row[form] = gate_bf16(f"{LAZY_FORM} {form} {label}", got[form], twin, twin32,
                                  twin_cpu, failures)
        if len(forms) == 2:
            row["forms_equal"] = bool(torch.equal(got["whole"], got["stream"]))
            fail_if(failures, not row["forms_equal"], f"{LAZY_FORM}: forms differ at {label}")
        controls = {"eager_twin": bf16_gate_row(plain(*args), twin, twin32, twin_cpu)}
        for left_out in ("att", "att_z"):
            controls[left_out] = bf16_gate_row(plain(*args, unrounded=(left_out,), lazy=True),
                                               twin, twin32, twin_cpu)
        for name, c in controls.items():
            fail_if(failures, c["passed"], f"{LAZY_FORM} {label}: the control {name} passes")
        row["controls_rms_ratio"] = {n: c["rms_ratio"] for n, c in controls.items()}
        out[label] = row
    first = out["128x91"]
    return {"name": LAZY_FORM, "route": "cuda",
            "source": "hig_tpu_torch/csrc/efficient_attention.cu",
            "replaces": "hig_tpu/ops/pallas_attention.py:46 (LAZY_KNORM, "
                        "hig_tpu/models/attention.py:114)",
            "max_abs_err": max(r[f]["max_abs_err"] for r in out.values()
                               for f in ("whole", "stream") if f in r),
            "ms": first["whole_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "forms": out}


def single_transformer_step_gate(device, failures) -> dict:
    """One bfloat16 --single_transformer PIT step at a native window of
    ST_WINDOW (2 × 197 = 394 merged rows, past the whole form's 320), full
    width cut to its first layer, ST_PAIRS pairs of ragged lengths: its loss
    and gradients through B3-bf16 (its streaming form) on the card against
    the plain route on the card within BF16_TRAIN_RMS of the bfloat16
    effect, beside the control route (JAX's use_pallas forward), which must
    exceed it, as phase 11 holds its steps; and against the same step on
    the CPU (the plain twin; the effect the CPU's bfloat16 step against its
    float32 one) within BF16_ROUTE_RMS, as phase 13 holds its bfloat16
    first layer to its CPU twin: there cuBLAS's bfloat16 GEMMs and the
    CPU's round the rest of the layer in other orders."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import ModelConfig
    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention
    from hig_tpu_torch.train import trainer as tr

    cfg = ModelConfig(single_transformer=True, compute_dtype="bfloat16", cap_id=True)
    initial = serve.build_model(cfg, device, random_init=0)
    Tw = ST_WINDOW + 1
    gen = torch.Generator().manual_seed(3)
    batch = {"motion": torch.randn((ST_PAIRS, 2, Tw, 263), generator=gen),
             "lengths": torch.tensor([Tw, 150, 97, Tw - 30][:ST_PAIRS]),
             "cap_ids": torch.randint(0, 43, (ST_PAIRS, 2), generator=gen)}
    t = torch.randint(0, 1000, (ST_PAIRS,), generator=gen)
    noise = torch.randn(batch["motion"].shape, generator=gen)
    sched = g.make_schedule(g.linear_betas(1000))

    def route(dtype, where, ctx=contextlib.nullcontext()):
        model = train_cut(initial, dtype).to(where)
        b = {k: v.to(where) for k, v in batch.items()}
        with ctx:
            loss, _ = tr.compute_grads(model, tr.make_loss_fn(model, sched, True), b,
                                       t=t.to(where), noise=noise.to(where))
        return float(loss), {n: p.grad.detach().cpu().clone()
                             for n, p in model.named_parameters() if p.grad is not None}

    reset_counts()
    kernel = route(None, device)
    launches = fused_efficient_attention.launches_bf16
    plain = route(None, device, plain_blocks())
    control = route(None, device, use_pallas_forward())
    plain32 = route("float32", device, plain_blocks())
    twin, twin32 = route(None, "cpu"), route("float32", "cpu")

    def reading(got, want, want32):
        return {"loss_ratio": abs(got[0] - want[0]) / abs(want[0] - want32[0]),
                "grad_ratio": tree_rms_ratio(got[1], want[1], want32[1])}

    row = {"window": ST_WINDOW, "merged_rows": 2 * Tw, "pairs": ST_PAIRS, "layers": 1,
           "b3_bf16_launches": launches, "loss_card": kernel[0], "loss_card_plain": plain[0],
           "loss_cpu_twin": twin[0], "loss_cpu_f32": twin32[0],
           "vs_plain_route": reading(kernel, plain, plain32),
           "control_vs_plain_route": reading(control, plain, plain32), "lim": BF16_TRAIN_RMS,
           "vs_cpu_twin": reading(kernel, twin, twin32), "cpu_twin_lim": BF16_ROUTE_RMS}
    fail_if(failures, launches < 1 or max(row["vs_plain_route"].values()) > BF16_TRAIN_RMS,
            f"bf16 --single_transformer window {ST_WINDOW} step against the plain route {row}")
    fail_if(failures, max(row["control_vs_plain_route"].values()) <= BF16_TRAIN_RMS,
            f"bf16 --single_transformer window {ST_WINDOW}: the control passes {row}")
    fail_if(failures, max(row["vs_cpu_twin"].values()) > BF16_ROUTE_RMS,
            f"bf16 --single_transformer window {ST_WINDOW} step against its CPU twin {row}")
    return row


def phase_geometry(device, failures, smi: str, tmp: str) -> tuple[dict, dict, dict]:
    """Phase 14 (see the module doc). Returns (the launch counts of its
    main path by form, B3-bf16's rows of both forms, the row of its lazy
    forms)."""
    t_phase = time.perf_counter()
    data, row = geometry_dataset(failures, tmp)
    print(json.dumps({"phase": "geometry", "run": "make_synthetic_data", "nvidia_smi": smi,
                      **row}), flush=True)
    print(json.dumps({"phase": "geometry", "run": "preprocess", "nvidia_smi": smi,
                      **geometry_preprocess(failures, tmp)}), flush=True)
    with open(os.path.join(data, "train_sub.txt")) as f:
        steps = len(f.read().split()) * GEO_TIMES // TRAIN_PAIRS
    trainer, state, row, counts = train_run("geo_pit", ["--times", str(GEO_TIMES)], steps,
                                            "projected_attention", data, tmp, failures, smi)
    row["loss_curve_png"] = os.path.exists(os.path.join(trainer.cfg.save_root, "result",
                                                        "result_loss.png"))
    print(json.dumps({**row, "phase": "geometry"}), flush=True)
    fail_if(failures, steps != GEO_STEPS, f"geometry: {steps} PIT steps, expected {GEO_STEPS}")
    opt_path = os.path.join(trainer.cfg.save_root, "opt.txt")
    del trainer, state
    vis, vis_counts = geometry_visualize(failures, opt_path, tmp)
    print(json.dumps({"phase": "geometry", "run": "visualize", "nvidia_smi": smi, **vis}),
          flush=True)
    forms = b3_bf16_forms(device, failures)
    print(json.dumps({"phase": "geometry", "kernel": "efficient_attention_bf16",
                      "forms": forms}), flush=True)
    lazy_row = b3_lazy_forms(device, failures)
    print(json.dumps({"phase": "geometry", "kernel": LAZY_FORM, "nvidia_smi": smi,
                      **lazy_row}), flush=True)
    step = single_transformer_step_gate(device, failures)
    print(json.dumps({"phase": "geometry", "run": "single_transformer_bf16_w196", **step}),
          flush=True)
    launches = merge_counts({k: v for k, v in counts.items() if k != BF16_SUM}, vis_counts)
    launches["efficient_attention_bf16"] = launches.get("efficient_attention_bf16", 0) \
        + step["b3_bf16_launches"]
    print(json.dumps({"phase": "geometry", "launches": launches,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches, forms, lazy_row


# Phase 15: the rest of Queue A. Distillation from phase 7's cfg_supervised
# run (its opt.txt: DDIM-50, a 32-clip subset): one stage 50 -> 25 at
# --times 2, two steps of 32 pairs. One distillation step launches B1 2 x 16
# times (the teacher's two half-steps: one denoiser call each over B pairs,
# or over the conditional and null 2B pairs under --distill_w, 8 layers x 2
# efficient blocks, eval mode, fused) and B2 16 times (the student's forward
# in train mode; its backward recomputes the plain version and launches
# nothing), nothing else.
DISTILL_STAGE, DISTILL_TIMES, DISTILL_WS = 25, 2, (1.0, 2.5)
DISTILL_STEP_LAUNCHES = {"fused_block": 2 * LAUNCHES_PER_STEP,
                         "projected_attention": LAUNCHES_PER_STEP}
DISTILL_CALL_B1 = LAUNCHES_PER_STEP * DISTILL_STAGE  # a DDIM-25 call of the student: 400
DISTILL_GRAPH_STEPS = 4  # the step-level graphed/eager check: the first captures
BPD_STEPS, BPD_PAIRS = 100, 4  # calc_bpd_loop: 100 denoiser calls, 1600 B1 launches
LIKELIHOOD_TOL = 1e-5  # vb and prior bits on the card against the CPU, of the largest
SMPL_VERTICES, SMPL_LENGTH, SMPL_REQUESTS = 6890, 91, 2  # 2 x 91 frames a request
SMPL_ITERATE_TOL, SMPL_OBJECTIVE_TOL = 1e-4, 0.01
SMPL_COMPARE_ITERS = 5  # the card-against-CPU fit: the CPU twin of serve's takes ~15 s
RENDER_ITERS = 10  # render_smpl --num_smplify_iters (the camera stage 10 times as many)
LEGACY_TOL = 1e-4


def distill_check(device, failures, opt: str) -> dict:
    """The distillation step at batch 32 from the cfg_supervised run (full
    width, the teacher fused): DISTILL_GRAPH_STEPS steps graphed and eager
    from one seed (metrics and the student bit for bit, each step's
    launches DISTILL_STEP_LAUNCHES), their ms and the capture; the loss and
    student gradients of a first step through the kernels against the
    plain route, gated as phase 6 gates a train step: at the run's initial
    weights (the train step's gates), and at its trained ones the loss and
    the exact-zero leaves, with the per-leaf errors reported (there
    float32 misses float64 by ~1e-3 of the smallest leaves in either route:
    PERF.md §6)."""
    from hig_tpu_torch.config import load_opt_txt, model_config
    from hig_tpu_torch.data.dataset import epoch_batches
    from hig_tpu_torch.diffusion import distill as pd
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.train import checkpoint as ckpt
    from hig_tpu_torch.train.trainer import Trainer, TrainState, eval_params, make_optimizer

    cfg = load_opt_txt(opt)
    trainer = Trainer(cfg, device)
    weights = eval_params(ckpt.load(os.path.join(cfg.model_dir, "latest.pt")))
    mcfg = model_config(cfg)
    with torch.device(device):
        teacher = InteractionModel(dataclasses.replace(mcfg, fused_blocks=True))
    teacher.load_state_dict(weights)
    teacher.to(device).eval().requires_grad_(False)
    batch = trainer._device_batch(
        next(epoch_batches(trainer_dataset(cfg), TRAIN_PAIRS, 0, seed=cfg.seed)),
        trainer.precompute_tower(teacher))
    grids = pd.distill_grids(trainer.sched.num_timesteps, DISTILL_STAGE, cfg.ddim_steps)

    def student():
        with torch.device(device):
            model = InteractionModel(mcfg)
        model.load_state_dict(weights)
        return model.to(device).train()

    runs, row = {}, {}
    for graph in (False, True):
        model = student()
        state = TrainState(model=model, optimizer=make_optimizer(cfg, model))
        step = pd.make_distill_step(trainer.sched, grids, teacher, graph=graph)
        metrics, walls, counts = [], [], []
        for i in range(DISTILL_GRAPH_STEPS):
            gen = torch.Generator(device=device).manual_seed(100 + i)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch, gen)
            values = torch.stack([m[k] for k in pd.DISTILL_METRICS]).cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts.append({k: v for k, v in bf16_counts().items() if v})
            metrics.append(values)
        runs[graph] = (torch.stack(metrics), {k: v.detach().clone()
                                              for k, v in model.state_dict().items()})
        key = "graphed" if graph else "eager"
        row[f"{key}_step_ms"] = statistics.median(walls[1:])
        row[f"{key}_first_step_ms"] = walls[0]
        fail_if(failures, any(c != DISTILL_STEP_LAUNCHES for c in counts),
                f"distill step ({key}) launches {counts}")
        if graph:
            captured = list(step.graphs.values())
            row["graph"] = captured[0].summary() if len(captured) == 1 else len(captured)
            fail_if(failures, len(captured) != 1, f"distill step graphs {len(captured)}")
        del state, step, model
    row["graph_equals_eager"] = bool(torch.equal(runs[True][0], runs[False][0]) and all(
        torch.equal(v, runs[False][1][k]) for k, v in runs[True][1].items()))
    row["loss_distill"] = runs[True][0][:, 0].tolist()
    fail_if(failures, not row["graph_equals_eager"], "distill step: graphed != eager")
    fail_if(failures, not torch.isfinite(runs[True][0]).all(), "distill step: non-finite")

    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    with torch.device(device):  # the cfg_supervised run's seeded start (Trainer.init_state)
        initial = load_flax_tree(InteractionModel(mcfg),
                                 random_flax_tree(mcfg, cfg.seed)["params"]).state_dict()
    for key, weights_at in (("grad_check", initial), ("grad_check_trained", weights)):
        gc = distill_grad_routes(mcfg, weights_at, trainer.sched, grids, batch)
        row[key] = gc
        gate_grad_check(failures, "distill", key, gc)
    return row


def distill_grad_routes(mcfg, weights: dict, sched, grids, batch: dict) -> dict:
    """The distillation loss of one fixed draw (grid indices, noise, a keep
    mask dropping 8 of the 32 pairs) and every student gradient, the
    student and the fused teacher both at ``weights``, through the kernels
    against the plain versions, as ``grad_route_errors`` holds a train step."""
    from hig_tpu_torch.diffusion import distill as pd
    from hig_tpu_torch.models.interaction_model import InteractionModel

    device = batch["motion"].device
    with torch.device(device):  # built on the card: the CPU's init of CLIP takes seconds
        student = InteractionModel(mcfg)
        teacher = InteractionModel(dataclasses.replace(mcfg, fused_blocks=True))
    student.load_state_dict(weights)
    student.to(device).train()
    teacher.load_state_dict(weights)
    teacher.to(device).eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(7)
    i = torch.randint(0, grids.num_steps, (TRAIN_PAIRS,), generator=gen, device=device)
    noise = torch.randn(batch["motion"].shape, generator=gen, device=device)
    keep = torch.arange(TRAIN_PAIRS, device=device) % 4 != 0

    def route(plain: bool):
        student.zero_grad(set_to_none=True)
        with plain_blocks() if plain else contextlib.nullcontext():
            loss, _ = pd.make_distill_loss(student, teacher, sched, grids)(batch, None, i, noise,
                                                                           keep)
            loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in student.named_parameters()
                             if p.grad is not None}

    loss_k, got = route(False)
    loss_p, want = route(True)
    zero = zero_grad_leaves(student)
    rel = leaf_rel_errs(got, want, zero)
    worst = max(rel, key=rel.get)
    scale = max(float(w.abs().max()) for w in want.values())
    gc = {"loss_kernels": loss_k, "loss_plain": loss_p,
          "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "leaves": len(want),
          "same_leaves": got.keys() == want.keys(), "grad_rel_err_max": rel[worst],
          "grad_rel_err_worst_leaf": worst, "worst_leaf_max": float(want[worst].abs().max()),
          "grad_rel_err_median": statistics.median(rel.values()),
          "zero_grad_leaves_max": max(float(got[n].abs().max()) / scale
                                      for n in got if n.endswith(zero)),
          "grad_max": scale, "kept_pairs": int(keep.sum())}
    return gc


def distill_runs(failures, smi: str, data: str, tmp: str, smpl_npz: str) -> tuple[dict, dict]:
    """``python -m hig_tpu_torch.distill``'s main from the cfg_supervised run,
    one stage 50 -> 25 with --distill_w 1 and 2.5, each then served by
    ``serve``: the w = 1 stage 16 requests in two calls of 8 (the capture,
    then a replay), then 3 more replays timed; the w = 2.5 stage, which
    samples unguided, SMPL_REQUESTS requests of SMPL_LENGTH frames with
    --fit_smpl on the SMPL_VERTICES-vertex synthetic model. Returns (rows,
    the launch counts of these runs by form)."""
    from hig_tpu_torch import distill, serve

    opt = os.path.join(tmp, "runs", "ntu_mul", "cfg_supervised", "opt.txt")
    stage = os.path.join(os.path.dirname(opt) + f"_distill{DISTILL_STAGE}", "opt.txt")
    rows, total = {}, {}
    made, fits = [], []
    real_make, real_fit = serve.make_sampler, serve.fit_smpl

    def spy_make(*args, **kw):
        made.append((kw, real_make(*args, **kw)))
        return made[-1][1]

    def spy_fit(*args, **kw):
        t0 = time.perf_counter()
        fits.append(real_fit(*args, **kw))
        fits.append(time.perf_counter() - t0)
        return fits[-2]

    serve.make_sampler, serve.fit_smpl = spy_make, spy_fit
    try:
        for w in DISTILL_WS:
            label = f"distill_w{w}"
            reset_counts()
            t0 = time.perf_counter()
            distill.main(["--opt_path", opt, "--stages", str(DISTILL_STAGE), "--epochs_per_stage",
                          "1", "--times", str(DISTILL_TIMES), "--distill_w", str(w),
                          "--log_every", "1"])
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in bf16_counts().items() if v}
            with open(os.path.join(os.path.dirname(stage), "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f][-DISTILL_TIMES:]
            steps = len(lines)
            want = {k: steps * n for k, n in DISTILL_STEP_LAUNCHES.items()}
            opt_text = open(stage).read()
            row = {"wall_s": wall, "steps": steps, "launches": counts, "expected": want,
                   "loss_distill": [x["loss_distill"] for x in lines],
                   "grad_norm": [x["grad_norm"] for x in lines],
                   "opt_ddim_steps": f"ddim_steps: {DISTILL_STAGE}" in opt_text,
                   "opt_guidance_1": "guidance_scale: 1.0" in opt_text}
            fail_if(failures, counts != want or steps != DISTILL_TIMES,
                    f"{label}: launches {counts}, expected {want} ({steps} steps)")
            fail_if(failures, not all(math.isfinite(x) for x in row["loss_distill"]),
                    f"{label}: losses {row['loss_distill']}")
            fail_if(failures, not (row["opt_ddim_steps"] and "sampler: ddim" in opt_text
                                   and (w == 1.0 or row["opt_guidance_1"])),
                    f"{label}: stage opt.txt")
            total = merge_counts(total, counts)

            reqs = os.path.join(tmp, f"{label}_requests.jsonl")
            out = os.path.join(tmp, f"{label}_serve")
            if w == 1.0:
                requests = serve_requests() * 2
                extra = ["--batch_size", str(N_PAIRS)]
                want_b1 = 2 * DISTILL_CALL_B1 + LAUNCHES_PER_STEP
            else:
                requests = [{**r, "length": SMPL_LENGTH} for r in serve_requests()[:SMPL_REQUESTS]]
                extra = ["--fit_smpl", "--smpl_model", smpl_npz]
                want_b1 = DISTILL_CALL_B1 + LAUNCHES_PER_STEP
            with open(reqs, "w") as f:
                f.write("".join(json.dumps({**r, "id": f"r{i}"}) + "\n"
                                for i, r in enumerate(requests)))
            made.clear()
            reset_counts()
            t0 = time.perf_counter()
            serve.main(["--requests", reqs, "--opt_path", stage, "--out_dir", out, *extra])
            serve_wall = time.perf_counter() - t0
            counts = {k: v for k, v in bf16_counts().items() if v}
            kw, sample = made[0]
            srow = {"wall_s": serve_wall, "launches": counts, "expected_b1": want_b1,
                    "sampler": kw["sampler"], "ddim_steps": kw["ddim_steps"],
                    "guidance_scale": kw["guidance_scale"]}
            fail_if(failures, counts != {"fused_block": want_b1},
                    f"{label} serve: launches {counts}, expected {want_b1} B1")
            fail_if(failures, (kw["sampler"], kw["ddim_steps"], kw["guidance_scale"])
                    != ("ddim", DISTILL_STAGE, 1.0), f"{label} serve: sampler {kw}")
            total = merge_counts(total, counts)
            if w == 1.0:
                from hig_tpu_torch.serve import conditioning_for

                cond = torch.from_numpy(conditioning_for(serve_requests())).to("cuda")
                lengths = torch.tensor([r["length"] + 1 for r in serve_requests()], device="cuda")
                walls = []
                for k in range(SERVE_CALLS):
                    reset_counts()
                    gen = torch.Generator(device="cuda").manual_seed(k)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sample(cond, lengths, generator=gen)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    counts = {k2: v for k2, v in bf16_counts().items() if v}
                    fail_if(failures, counts != {"fused_block": DISTILL_CALL_B1},
                            f"{label} DDIM-{DISTILL_STAGE} replay launches {counts}")
                    total = merge_counts(total, counts)
                srow["ddim25_call_ms"] = statistics.median(walls)
                srow["graph"] = list(sample.graphs.values())[0].summary()
            else:
                with open(os.path.join(out, "index.json")) as f:
                    index = json.load(f)
                results, fit_walls = fits[0::2], fits[1::2]
                srow["smpl"] = {
                    "fit_wall_s": fit_walls[0],
                    "fits": [{"frames": int(r.pose.shape[0]),
                              "evaluations": r.camera_info.evaluations + r.body_info.evaluations,
                              "camera_iterations": len(r.camera_info.linesearch_steps),
                              "body_iterations": len(r.body_info.linesearch_steps),
                              "final_loss": float(r.final_loss)} for r in results[0]],
                    "files": all(os.path.exists(e.get("smpl", "")) for e in index)}
                fail_if(failures, not srow["smpl"]["files"] or len(results[0]) != SMPL_REQUESTS
                        or any(f["frames"] != 2 * SMPL_LENGTH or not math.isfinite(f["final_loss"])
                               for f in srow["smpl"]["fits"]), f"serve --fit_smpl {srow['smpl']}")
                rows["smpl_serve"] = (index[0]["path"], results[0][0], fit_walls[0])
            rows[label] = {"distill": row, "serve": srow}
            print(json.dumps({"phase": "rest", "run": label, "nvidia_smi": smi, **row,
                              "serve": srow}), flush=True)
    finally:
        serve.make_sampler, serve.fit_smpl = real_make, real_fit
    t0 = time.perf_counter()
    rows["check"] = distill_check(torch.device("cuda"), failures, opt)
    rows["check"]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase": "rest", "run": "distill_step", "nvidia_smi": smi,
                      **rows["check"]}), flush=True)
    return rows, total


def likelihood_check(model, device, failures) -> tuple[dict, dict]:
    """vb_terms_bpd and prior_bpd on one full-width batch (32 pairs, T = 91,
    t over the schedule with zeros, eps within 0.02 of the noise) on the
    card against the CPU twin; calc_bpd_loop over a BPD_STEPS-step schedule
    through the fused denoiser (16 B1 launches a step). Returns (row,
    launch counts)."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g

    sched = g.make_schedule(g.linear_betas(1000))
    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn(TRAIN_PAIRS, 2, T, 263, generator=gen).clamp(-1.2, 1.2)
    noise = torch.randn(x0.shape, generator=gen)
    t = torch.randint(0, 1000, (TRAIN_PAIRS,), generator=gen)
    t[:4] = 0
    out = noise + 0.02 * torch.randn(x0.shape, generator=gen)
    twins = {}
    for d in (device, torch.device("cpu")):
        x_t = g.q_sample(sched, x0.to(d), t.to(d), noise.to(d))
        vb, _ = g.vb_terms_bpd(sched, out.to(d), x0.to(d), x_t, t.to(d))
        twins[d.type] = (vb.cpu(), g.prior_bpd(sched, x0.to(d)).cpu())
    row = {"vb_rel_err": float((twins["cuda"][0] - twins["cpu"][0]).abs().max()
                               / twins["cpu"][0].abs().max()),
           "prior_rel_err": float((twins["cuda"][1] - twins["cpu"][1]).abs().max()
                                  / twins["cpu"][1].abs().max())}
    fail_if(failures, not (row["vb_rel_err"] <= LIKELIHOOD_TOL
                           and row["prior_rel_err"] <= LIKELIHOOD_TOL),
            f"likelihood terms card vs CPU {row}")

    sched100 = g.make_schedule(g.linear_betas(BPD_STEPS))
    requests = serve_requests()[:BPD_PAIRS]
    cond = torch.from_numpy(serve.conditioning_for(requests)).to(device)
    lengths = torch.tensor([r["length"] + 1 for r in requests], device=device)
    with torch.no_grad():
        xf_proj, xf_out = model.encode_text(cond)
        text_kv = model.text_kv(xf_out)
        x_start = torch.randn(BPD_PAIRS, 2, T, 263, generator=gen).clamp(-1, 1).to(device)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpd = g.calc_bpd_loop(sched100, lambda x, tt: model.denoise(x, tt, lengths, xf_proj,
                                                                    text_kv=text_kv),
                              x_start, generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
    counts = {k: v for k, v in bf16_counts().items() if v}
    row.update(bpd_wall_ms=(time.perf_counter() - t0) * 1e3, bpd_launches=counts,
               total_bpd=bpd["total_bpd"].tolist(), prior_bpd=bpd["prior_bpd"].tolist(),
               vb_shape=list(bpd["vb"].shape))
    fail_if(failures, counts != {"fused_block": BPD_STEPS * LAUNCHES_PER_STEP},
            f"calc_bpd_loop launches {counts}")
    fail_if(failures, row["vb_shape"] != [BPD_STEPS, BPD_PAIRS]
            or not all(torch.isfinite(v).all() for v in bpd.values())
            or not torch.allclose(bpd["total_bpd"], bpd["vb"].sum(0) + bpd["prior_bpd"]),
            f"calc_bpd_loop output {row}")
    return row, counts


def smpl_check(device, failures, served: tuple, smpl_npz: str, tmp: str) -> dict:
    """For the first served request's joints (2 x SMPL_LENGTH frames) and
    its fit on the card in ``serve --fit_smpl``: the camera stage's L-BFGS
    for 5 iterations on the card graphed, on the card eager (equal bit for
    bit) and on the CPU, on SMPL-posed joints of as many frames (iterates
    within SMPL_ITERATE_TOL of the CPU's) and on the served joints
    (reported: a random-weight model's motions put the objective near 5e13,
    where float32's order of sums alone moves a 17-step line search's
    iterates ~1e-4); a fit of SMPL_COMPARE_ITERS iterations (the camera
    stage 10 times as many) of the served joints on the card and on the
    CPU, whose final objectives must agree within SMPL_OBJECTIVE_TOL, with
    walls and evaluations beside the serve fit's; then ``python -m
    hig_tpu_torch.render_smpl --no-gif`` on the joints."""
    from hig_tpu_torch import render_smpl
    from hig_tpu_torch.smpl import lbs as tl
    from hig_tpu_torch.smpl import smplify
    from hig_tpu_torch.smpl.fit import joint_confidences
    from hig_tpu_torch.smpl.lbfgs import lbfgs_run
    from hig_tpu_torch.smpl.prior import synthetic_gmm_prior

    path, card_fit, card_wall = served
    joints = np.load(path)["joints"]
    N = joints.shape[0] * joints.shape[1]
    j3d_cpu = torch.from_numpy(np.asarray(joints.reshape(N, 22, 3), np.float32))
    cpu_model = tl.load_smpl_model(smpl_npz)
    # SMPL-posed joints (seeded poses and shapes, 2 cm of noise): the
    # well-scaled input the iterates are gated on
    gen = torch.Generator().manual_seed(3)
    _, posed = tl.lbs(cpu_model, 0.5 * torch.randn(N, 10, generator=gen),
                      0.3 * torch.randn(N, 72, generator=gen))
    posed = posed[:, :22] + 0.02 * torch.randn(N, 22, 3, generator=gen)
    lbfgs_rows = {}
    for name, j3d_host in (("posed", posed), ("served", j3d_cpu)):
        iterates = {}
        for label, d, graph in (("graphed", device, True), ("eager", device, False),
                                ("cpu", torch.device("cpu"), False)):
            model, j3d = cpu_model.to(d), j3d_host.to(d)
            zeros = torch.zeros(N, 72, device=d)
            init_cam = smplify.guess_init_3d(tl.lbs_joints(model, zeros[:, :10], zeros), j3d)

            def cam_loss(p, model=model, j3d=j3d, init_cam=init_cam, zeros=zeros):
                mj = tl.lbs_joints(model, zeros[:, :10],
                                   torch.cat([p["global_orient"], zeros[:, 3:]], dim=-1))
                return smplify.camera_fitting_loss_3d(mj[:, :22], p["cam_t"], init_cam, j3d)

            iterates[label] = lbfgs_run(cam_loss, {"global_orient": zeros[:, :3],
                                                   "cam_t": init_cam}, 5,
                                        record_iterates=True, graph=graph)[2]
        lbfgs_rows[name] = {
            "iterate_rel_err": max(float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max())
                                   for a, b in zip(iterates["graphed"].iterates,
                                                   iterates["cpu"].iterates) for k in b),
            "graphed_equals_eager": all(torch.equal(a[k], b[k]) for a, b in zip(
                iterates["graphed"].iterates, iterates["eager"].iterates) for k in b),
            "linesearch_steps": iterates["graphed"].linesearch_steps,
            "same_linesearch_steps": iterates["graphed"].linesearch_steps
            == iterates["cpu"].linesearch_steps}
    err = lbfgs_rows["posed"]["iterate_rel_err"]
    same = all(r["graphed_equals_eager"] for r in lbfgs_rows.values())
    row = {"frames": N, "serve_fit_wall_s": card_wall,
           "serve_fit_evaluations": (card_fit.camera_info.evaluations
                                     + card_fit.body_info.evaluations)}
    losses = {}
    for d in (device, torch.device("cpu")):
        fit = smplify.SMPLify3D(model=cpu_model.to(d), prior=synthetic_gmm_prior().to(d),
                                num_iters=SMPL_COMPARE_ITERS)
        t0 = time.perf_counter()
        result = fit(torch.zeros(N, 72, device=d), torch.zeros(N, 10, device=d), j3d_cpu.to(d),
                     joint_confidences(d))
        losses[d.type] = float(result.final_loss)
        row[f"{d.type}_fit_wall_s"] = time.perf_counter() - t0
        row[f"{d.type}_evaluations"] = (result.camera_info.evaluations
                                        + result.body_info.evaluations)
    row.update(lbfgs=lbfgs_rows, final_loss=losses,
               final_loss_rel_diff=abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]))
    fail_if(failures, not (err <= SMPL_ITERATE_TOL and same
                           and row["final_loss_rel_diff"] <= SMPL_OBJECTIVE_TOL),
            f"SMPL card vs CPU {row}")

    npy = os.path.join(tmp, "smpl_joints.npy")
    np.save(npy, joints)
    out = os.path.join(tmp, "render_smpl")
    t0 = time.perf_counter()
    rendered = render_smpl.main(["--file_name", npy, "--save_dir", out, "--smpl_model",
                                 smpl_npz, "--num_smplify_iters", str(RENDER_ITERS), "--no-gif"])
    row["render_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(out, "smpl_joints.pkl"), "rb") as f:
        import pickle

        meshes = pickle.load(f)
    row["render_meshes"] = [list(m.shape) for m in meshes]
    row["render_evaluations"] = (rendered.camera_info.evaluations
                                 + rendered.body_info.evaluations)
    fail_if(failures, row["render_meshes"] != [[SMPL_LENGTH, SMPL_VERTICES, 3]] * 2
            or not all(np.isfinite(m).all() for m in meshes)
            or not os.path.exists(os.path.join(out, "smpl_joints_params.npz")),
            f"render_smpl {row['render_meshes']}")
    return row


def legacy_check(device, failures, data: str) -> dict:
    """CoEmbeddingEvaluator at the reference's widths (seeded weights) on
    phase 9's EVAL_CLIPS test clips at EVAL_T (the first actor's features,
    the first caption's words) on the card against the CPU twin
    (LEGACY_TOL), its ms, and the matching score and R-precision of the
    protocol's batches of 32 (the first 32 clips)."""
    from hig_tpu_torch.data.word_vectorizer import WordVectorizer
    from hig_tpu_torch.eval.legacy_protocol import (
        CoEmbeddingEvaluator,
        evaluate_matching_and_r_precision,
        vectorize_tokens,
    )

    with open(os.path.join(data, "test_sub.txt")) as f:
        names = f.read().split()
    motions = np.zeros((len(names), EVAL_T, 263), np.float32)
    m_lens, vecs, wv = [], [], WordVectorizer()
    for i, name in enumerate(names):
        clip = np.load(os.path.join(data, "new_joint_vecs", name + ".npy"))[0]
        n = min(len(clip), EVAL_T)
        motions[i, :n] = clip[:n]
        m_lens.append(n)
        with open(os.path.join(data, "texts", name + ".txt")) as f:
            caption = f.readline().split("#")[0].split("_")[0]
        vecs.append(vectorize_tokens([f"{w}/OTHER" for w in caption.split()], 20, wv))
    inputs = (motions, np.asarray(m_lens), np.stack([v[0] for v in vecs]),
              np.stack([v[1] for v in vecs]), np.asarray([v[2] for v in vecs]))
    out, row = {}, {"clips": len(names)}
    for d in (device, torch.device("cpu")):
        ev = CoEmbeddingEvaluator(263, device=d)
        ev.get_co_embeddings(*inputs)
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[d.type] = [e.cpu() for e in ev.get_co_embeddings(*inputs)]
        row[f"{d.type}_ms"] = (time.perf_counter() - t0) * 1e3
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
    match, r_prec = evaluate_matching_and_r_precision(out["cuda"][0].numpy(),
                                                      out["cuda"][1].numpy())
    row.update(text_rel_err=errs[0], motion_rel_err=errs[1], matching_score=float(match),
               r_precision=[float(x) for x in r_prec])
    fail_if(failures, max(errs) > LEGACY_TOL or not all(np.isfinite(row["r_precision"])),
            f"legacy co-embeddings card vs CPU {row}")
    return row


def phase_rest(device, failures, smi: str, data: str, tmp: str, fused_model) -> dict:
    """Phase 15 (see the module doc). Returns the launch counts of its main
    path by form: the distillation runs, the distilled students' serving
    calls and calc_bpd_loop (the step-level check's and the gradient
    check's launches compare routes and are left out)."""
    from hig_tpu_torch.smpl.lbs import save_smpl_npz, synthetic_smpl_model

    t_phase = time.perf_counter()
    smpl_npz = os.path.join(tmp, f"smpl_synthetic_{SMPL_VERTICES}.npz")
    save_smpl_npz(synthetic_smpl_model(SMPL_VERTICES), smpl_npz)
    parts = {}

    def lap(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    rows, launches = distill_runs(failures, smi, data, tmp, smpl_npz)
    t0 = lap("distill", t0)
    row, counts = likelihood_check(fused_model, device, failures)
    launches = merge_counts(launches, counts)
    print(json.dumps({"phase": "rest", "run": "likelihood", "nvidia_smi": smi, **row}),
          flush=True)
    t0 = lap("likelihood", t0)
    reset_counts()
    row = smpl_check(device, failures, rows["smpl_serve"], smpl_npz, tmp)
    print(json.dumps({"phase": "rest", "run": "smpl", "nvidia_smi": smi, **row}), flush=True)
    t0 = lap("smpl", t0)
    row = legacy_check(device, failures, data)
    print(json.dumps({"phase": "rest", "run": "legacy", "nvidia_smi": smi, **row}), flush=True)
    lap("legacy", t0)
    counts = {k: v for k, v in bf16_counts().items() if v}
    fail_if(failures, bool(counts), f"SMPL and the legacy protocol launched {counts}")
    print(json.dumps({"phase": "rest", "launches": launches, "parts_s": parts,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches


# Phase 16: two ranks on the one card over gloo (NCCL refuses two ranks on
# one device), at full width from the phase's seed: DP, FSDP, TP, PP and DP
# serving, each against its one-rank counterpart. The ranks share a card, so
# their times say nothing of scaling.
PAR_RANKS, PAR_PAIRS, PAR_STEPS, PAR_SEED = 2, 32, 2, 16
PAR_REQUESTS = 16
PAR_TIMEOUT = 300  # seconds the ranks may take once phase 16 starts
# FSDP's step against DP's: the gradients per leaf as phase 6's routes
# (TRAIN_GRAD_TOL of the leaf, the exact-zero ones TRAIN_ZERO_GRAD_TOL of
# the largest); an Adam step moves each element by about lr whatever its
# gradient's size, so the updated weights are held where the gradient is
# at least PAR_LIVE_GRAD of its leaf's largest, within PAR_UPDATE_TOL · lr.
PAR_LIVE_GRAD, PAR_UPDATE_TOL = 1e-3, 1e-2
RECT_DOUT = D // 2  # a TP rank's q|k|v width: 4 of the 8 heads
# (f) train_single on phase 12's t2m data: 48 clips twice over, 2 steps of 48
PAR_SINGLE_ARGS = ["--dataset_name", "t2m", "--batch_size", "48", "--num_epochs", "1",
                   "--times", "2", "--log_every", "1", "--seed", "0"]
PAR_SINGLE_STEPS = 2
PAR_TP_STEPS = 25  # (c)'s DDIM call: the depth cut to pay for (f)-(h)
PAR_DISTILL_STAGE = 25  # (g) one stage from phase 7's cfg_supervised run: 1 step of 32
PAR_PRETRAINED = {"fsdp": {"fsdp": True}, "tp": {"tp": True}}  # (h), each 1 x 2


def par_cfg(tmp: str, **kw):
    """The phase's full-width caption-id run (global batch 32, T = 91)."""
    from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths

    return add_dataset_paths(ExperimentConfig(
        name="par", dataset_name="synthetic_mul", data_root=tmp, checkpoints_dir=tmp,
        cap_id=True, batch_size=PAR_PAIRS, seed=PAR_SEED, **kw))


def par_inputs(step: int) -> dict:
    """The global batch of PIT step ``step`` and its t and noise (numpy)."""
    rs = np.random.RandomState(PAR_SEED + step)
    lengths = np.resize(np.asarray(LENGTHS) + 1, PAR_PAIRS)
    return {"motion": rs.randn(PAR_PAIRS, 2, T, 263).astype(np.float32), "lengths": lengths,
            "cap_ids": rs.randint(0, 43, (PAR_PAIRS, 2)), "t": rs.randint(0, 1000, PAR_PAIRS),
            "noise": rs.randn(PAR_PAIRS, 2, T, 263).astype(np.float32)}


def par_batch(x: dict, layout, device) -> tuple:
    """This rank's rows of ``x`` on the card: (batch, t, noise)."""
    from hig_tpu_torch.parallel.mesh import shard_batch

    x = shard_batch(x, layout.batch_index, layout.batch_count)
    batch = {"motion": torch.from_numpy(x["motion"]).to(device),
             "lengths": torch.from_numpy(x["lengths"]).long().to(device),
             "cap_ids": torch.from_numpy(x["cap_ids"]).long().to(device)}
    return batch, torch.from_numpy(x["t"]).long().to(device), torch.from_numpy(
        x["noise"]).to(device)


def par_steps(trainer, state, steps: int, device, after=None) -> dict:
    """``steps`` eager PIT steps of ``trainer``'s layout on par_inputs: the
    losses and gradient norms, each step's seconds, and B2's launches;
    ``after(i)`` runs after step i."""
    from hig_tpu_torch.train import trainer as tt

    layout = trainer.layout
    step = tt.make_train_step(trainer.sched, pit=True, graph=False,
                              layout=layout)
    reset_counts()
    out = {"metrics": [], "step_s": []}
    for i in range(steps):
        batch, t, noise = par_batch(par_inputs(i), layout, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, t=t, noise=noise)
        out["metrics"].append([float(metrics[k]) for k in tt.TRAIN_METRICS])
        out["step_s"].append(time.perf_counter() - t0)
        if after is not None:
            after(i)
    out["launches"] = bf16_counts()["projected_attention"]
    return out


def digest(tensors: dict) -> dict:
    """Each tensor's bytes hashed: two states compared bit for bit across
    processes without moving them."""
    import hashlib

    return {k: hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for k, t in tensors.items()}


def payload_digest(payload: dict) -> dict:
    """``digest`` of a one-rank checkpoint payload's parameters, Adam moments
    and EMA."""
    out = {f"params.{k}": v for k, v in digest(payload["params"]).items()}
    for i, entry in payload["opt_state"]["state"].items():
        out.update({f"{m}.{i}": v for m, v in digest(
            {m: entry[m] for m in ("exp_avg", "exp_avg_sq")}).items()})
    out.update({f"ema.{k}": v for k, v in digest(payload.get("ema_params") or {}).items()})
    return out


def par_pretrained(out: str, device, mode: str | None) -> dict:
    """(h) ``train --pretrained``'s load (``load_pretrained``) of phase 13's
    reference state dict into a full-width token model laid out by ``mode``
    (PAR_PRETRAINED; None: one rank), started from zero weights so that
    every value must come from the load: the gathered one-rank payload's
    digest, and one PIT step's loss and gradient norm on par_inputs(0)'s
    rows with their tower features."""
    from hig_tpu_torch.config import ExperimentConfig, MeshConfig, add_dataset_paths
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.parallel.mesh import shard_batch
    from hig_tpu_torch.train import checkpoint as ckpt
    from hig_tpu_torch.train import trainer as tt
    from hig_tpu_torch.train.__main__ import load_pretrained

    kw = {} if mode is None else dict(mesh=MeshConfig(1, PAR_RANKS), **PAR_PRETRAINED[mode])
    cfg = add_dataset_paths(ExperimentConfig(
        name=f"par_pretrained_{mode}", dataset_name="synthetic_mul", data_root=out,
        checkpoints_dir=out, batch_size=PAR_PAIRS, seed=PAR_SEED, pretrained=True, **kw))
    trainer = tt.Trainer(cfg, device, graph=False)
    with torch.device("meta"):
        shapes = tt.InteractionModel(trainer.model_config).state_dict()
    state = trainer.init_state({k: torch.zeros(v.shape) for k, v in shapes.items()})
    t0 = time.perf_counter()
    load_pretrained(trainer, state, os.path.join(os.path.dirname(out), "reference_latest.tar"))
    res = {"load_s": time.perf_counter() - t0, "mode": trainer.layout.mode,
           "digest": payload_digest(trainer.layout.full_payload(ckpt.payload_of(state, 0, 0)))}
    x = par_inputs(0)
    tokens = tokenize(CAPS).astype(np.int64)[x["cap_ids"]]
    x = shard_batch({**x, "tokens": tokens}, trainer.layout.batch_index,
                    trainer.layout.batch_count)
    cap_ids = torch.from_numpy(x["cap_ids"]).long().to(device)
    batch = {"motion": torch.from_numpy(x["motion"]).to(device),
             "lengths": torch.from_numpy(x["lengths"]).long().to(device),
             "tokens": torch.from_numpy(x["tokens"]).to(device),
             "tower_feats": trainer.precompute_tower(state.model)[cap_ids]}
    step = tt.make_train_step(trainer.sched, pit=True, graph=False, layout=trainer.layout)
    metrics = step(state, batch, t=torch.from_numpy(x["t"]).long().to(device),
                   noise=torch.from_numpy(x["noise"]).to(device))
    res["metrics"] = [float(metrics[k]) for k in tt.TRAIN_METRICS]
    return res


def par_distill_opt(out: str, name: str) -> str:
    """A copy of phase 7's cfg_supervised run under ``name`` (its opt.txt
    renamed, its model directory linked), so that each distillation writes
    its own stage: the opt.txt's path."""
    runs = os.path.join(os.path.dirname(out), "runs", "ntu_mul")
    src, dst = os.path.join(runs, "cfg_supervised"), os.path.join(runs, name)
    os.makedirs(dst, exist_ok=True)
    os.symlink(os.path.join(src, "model"), os.path.join(dst, "model"))
    os.symlink(os.path.join(src, "meta"), os.path.join(dst, "meta"))
    with open(os.path.join(src, "opt.txt")) as f:
        text = f.read()
    with open(os.path.join(dst, "opt.txt"), "w") as f:
        f.write(text.replace("name: cfg_supervised\n", f"name: {name}\n"))
    return os.path.join(dst, "opt.txt")


def par_entry_points(out: str, device, rank: int) -> dict:
    """(f), (g) and (h) on this rank (the module doc)."""
    from hig_tpu_torch import distill
    from hig_tpu_torch.parallel import distributed as dist
    from hig_tpu_torch.train_single import main as single_main

    res, parts = {}, {}
    t0 = time.perf_counter()
    # (f) train_single over the 2 data ranks, the state replicated (each
    # case hands back what it cached: the card is shared)
    reset_counts()
    state = single_main(["--name", "par_single", "--data_root",
                         os.path.join(os.path.dirname(out), "single_data"), "--checkpoints_dir",
                         os.path.join(out, "single_ranks"), "--distributed", *PAR_SINGLE_ARGS],
                        graph=False)
    res["single"] = {"steps": state.step, "counts": bf16_counts(),
                     "digest": digest(state.model.state_dict())}
    del state
    torch.cuda.empty_cache()
    parts["single"] = time.perf_counter() - t0
    # (g) distillation over the 2 data ranks, the teacher whole on each
    t0 = time.perf_counter()
    reset_counts()
    opt = os.path.join(os.path.dirname(out), "runs", "ntu_mul", "par_cfg_ranks", "opt.txt")
    if rank == 0:
        par_distill_opt(out, "par_cfg_ranks")
    dist.barrier()
    (written,) = distill.main(["--opt_path", opt, "--stages", str(PAR_DISTILL_STAGE),
                               "--epochs_per_stage", "1", "--log_every", "1"], graph=False)
    res["distill"] = {"stage": written, "counts": bf16_counts()}
    torch.cuda.empty_cache()
    parts["distill"] = time.perf_counter() - t0
    # (h) --pretrained under FSDP and TP
    for mode in PAR_PRETRAINED:
        t0 = time.perf_counter()
        res[f"pretrained_{mode}"] = par_pretrained(out, device, mode)
        torch.cuda.empty_cache()
        parts[f"pretrained_{mode}"] = time.perf_counter() - t0
    res["parts_s"] = parts
    return res


def par_entry_refs(out: str, device) -> dict:
    """The one-rank counterparts of (f), (g) and (h), on the card while the
    ranks run: train_single's and the distillation stage's metrics, and the
    --pretrained load's digest and step."""
    from hig_tpu_torch import distill
    from hig_tpu_torch.train_single import main as single_main

    refs = {}
    torch.cuda.empty_cache()
    single_main(["--name", "par_single_one", "--data_root",
                 os.path.join(os.path.dirname(out), "single_data"), "--checkpoints_dir",
                 os.path.join(out, "single_one"), *PAR_SINGLE_ARGS], graph=False)
    refs["single"] = read_metrics(os.path.join(out, "single_one", "t2m", "par_single_one"))
    (written,) = distill.main(["--opt_path", par_distill_opt(out, "par_cfg_one"), "--stages",
                               str(PAR_DISTILL_STAGE), "--epochs_per_stage", "1",
                               "--log_every", "1"], graph=False)
    refs["distill"] = read_metrics(written)
    torch.cuda.empty_cache()
    refs["pretrained"] = par_pretrained(out, device, None)
    torch.cuda.empty_cache()
    return refs


def read_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def par_requests() -> tuple:
    """Caption ids, lengths and x_T of PAR_REQUESTS requests (numpy)."""
    rs = np.random.RandomState(PAR_SEED)
    lengths = np.resize(np.asarray(LENGTHS) + 1, PAR_REQUESTS)
    return (rs.randint(0, 43, (PAR_REQUESTS, 2)), lengths,
            rs.randn(PAR_REQUESTS, 2, T, 263).astype(np.float32))


def par_serve_argv(tmp: str, out: str) -> list:
    """serve's arguments for the phase's requests and model (written by
    phase_parallel into ``tmp``), results into ``out``."""
    return ["--requests", os.path.join(tmp, "par_requests.jsonl"), "--random_init",
            str(PAR_SEED), "--model_config", os.path.join(tmp, "par_model.json"),
            "--out_dir", out]


def leaf_errors(got: dict, want: dict) -> tuple[float, float]:
    """(the largest per-leaf error over the leaf's largest magnitude, over
    the leaves with a nonzero exact gradient; the largest error of the
    exact-zero leaves over the model's largest gradient)."""
    scale = max(float(w.abs().max()) for w in want.values())
    live = zero = 0.0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        if name.endswith(CAP_ID_ZERO_GRAD):
            zero = max(zero, err / scale)
        else:
            live = max(live, err / max(float(w.abs().max()), 1e-30))
    return live, zero


def parallel_rank(rank: int, port: str, out: str) -> int:
    """One of phase 16's ranks (``python chip_smoke.py --parallel-rank r
    port dir``): the eight cases on cuda:0 over gloo; writes
    <dir>/rank<r>.json."""
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # two ranks and the parent share the host's cores
    from hig_tpu_torch import serve
    from hig_tpu_torch.config import MeshConfig
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
    from hig_tpu_torch.parallel import distributed as dist
    from hig_tpu_torch.train import trainer as tt

    device = dist.initialize(f"127.0.0.1:{port}", PAR_RANKS, rank, device="cuda")
    res = {"backend": dist.backend(), "device": str(device)}
    parts = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.empty_cache()  # the card is shared: hand back what this case cached
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # (a) DP, 2 x 1: two steps; the gradients and weights after the first
    # are FSDP's reference
    trainer = tt.Trainer(par_cfg(out, mesh=MeshConfig(PAR_RANKS, 1)), device, graph=False)
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    first = {}

    def keep(i):
        if i == 0:
            first["grads"] = {n: p.grad.clone() for n, p in state.model.named_parameters()
                              if p.grad is not None}
            first["params"] = {n: p.detach().clone() for n, p in
                               state.model.named_parameters()}

    res["dp"] = par_steps(trainer, state, PAR_STEPS, device, keep)
    del state, trainer
    lap("dp")

    # (b) FSDP, 1 x 2: one step, against DP's first
    trainer = tt.Trainer(par_cfg(out, mesh=MeshConfig(1, PAR_RANKS), fsdp=True), device,
                         graph=False)
    state = trainer.init_state(before)
    layout = trainer.layout
    res["fsdp"] = par_steps(trainer, state, 1, device)
    res["fsdp"]["shards"] = {n: list(t.shape) for n, t in layout.shards.items()}
    group = layout.mesh.model_group
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    for n, shard in layout.shards.items():
        grads[n] = dist.all_gather(shard.grad, layout.dims[n], group)
    layout.gather_params(state)
    res["fsdp"]["grad_live_err"], res["fsdp"]["grad_zero_err"] = leaf_errors(
        grads, first["grads"])
    lr, worst = trainer.cfg.lr, 0.0
    for n, p in state.model.named_parameters():
        grad = first["grads"].get(n)
        if grad is None:
            continue
        live = grad.abs() >= PAR_LIVE_GRAD * grad.abs().max()
        du = (p.detach() - first["params"][n]).abs()[live]
        if du.numel():
            worst = max(worst, float(du.max()) / lr)
    res["fsdp"]["update_err_lr"] = worst
    res["fsdp"]["moved"] = float(max((p.detach() - before[n]).abs().max()
                                     for n, p in state.model.named_parameters())) / lr
    del state, trainer, first, grads
    lap("fsdp")

    # (c) TP, 1 x 2: a DDIM-25 call for PAR_REQUESTS requests, each rank its
    # 4 heads through B2's rectangular form
    trainer = tt.Trainer(par_cfg(out, mesh=MeshConfig(1, PAR_RANKS), tp=True), device,
                         graph=False)
    model = trainer.init_state(before).model.eval()
    cap, lengths, noise = par_requests()
    sample = tt.make_sampler(model, g.make_schedule(g.linear_betas(1000)), T, 263, "ddim",
                             PAR_TP_STEPS, graph=False)
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    y = sample(torch.from_numpy(cap), torch.from_numpy(lengths), noise=torch.from_numpy(noise))
    torch.cuda.synchronize()
    res["tp"] = {"call_s": time.perf_counter() - t1, "counts": bf16_counts(),
                 "launches_rect": fused_projected_attention.launches_rect}
    if rank == 0:
        np.save(os.path.join(out, "tp_ddim.npy"), y.cpu().numpy())
    del model, trainer, sample
    lap("tp")

    # (d) PP, 1 x 2, pp_micro 2: one PIT step's loss and gradients against
    # the sequential stack on this rank (the same weights and inputs)
    trainer = tt.Trainer(par_cfg(out, mesh=MeshConfig(1, PAR_RANKS), pp_micro=2), device,
                         graph=False)
    state = trainer.init_state(before)
    model, layout = state.model, trainer.layout
    batch, t, noise = par_batch(par_inputs(0), layout, device)
    loss_fn = tt.make_loss_fn(model, trainer.sched.on(device), pit=True)
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_pp, _ = tt.compute_grads(model, loss_fn, batch, t=t, noise=noise)
    layout.reduce_grads(state)
    torch.cuda.synchronize()
    res["pp"] = {"step_s": time.perf_counter() - t1, "launches": bf16_counts()}
    grads_pp = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.denoiser.pipeline = None
    loss_seq, _ = tt.compute_grads(model, loss_fn, batch, t=t, noise=noise)
    grads_seq = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    res["pp"].update(loss=float(loss_pp), loss_seq=float(loss_seq))
    res["pp"]["grad_live_err"], res["pp"]["grad_zero_err"] = leaf_errors(grads_pp, grads_seq)
    del state, trainer, model, grads_pp, grads_seq
    lap("pp")

    # (e) serving, 2 x 1: each rank its 8 requests, the primary gathers and writes
    reset_counts()
    t1 = time.perf_counter()
    serve.main(par_serve_argv(out, os.path.join(out, "serve_dp")) + ["--device", "cuda"])
    res["serve"] = {"call_s": time.perf_counter() - t1, "counts": bf16_counts()}
    lap("serve")

    # (f)-(h): the entry points JAX runs over several devices
    res["entry_points"] = par_entry_points(out, device, rank)
    lap("entry_points")
    res["parts_s"] = parts
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def check_projected_attention_rect(device, failures) -> dict:
    """B2's rectangular form (a TP rank's (D/2, D) q|k|v weights, 4 heads:
    rank 1's rows) at the serving shape, float32 against its plain version
    and bfloat16 and B2-bf16a against their twins, as the interaction block
    calls it (kv from the partner). The row's time and bound are the
    float32 form's (the form phase 16's TP call launches), from the square
    form's operation count at Dout = 256."""
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain

    w, x, mask, _, _ = block_inputs(device)
    N, Tq, hd, heads = 2 * x.shape[0], x.shape[2], D // HEADS, HEADS // 2
    M = N * Tq
    rows = slice(D - RECT_DOUT, D)
    ws = [t[rows].contiguous() for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    kv, kmask = xn.flip(1).contiguous(), mask.flip(1).contiguous()
    cases = {}
    with torch.no_grad():
        args = (xn, kv, *ws, heads, kmask)
        got = fused_projected_attention(*args)
        err = (got - plain(*args)).abs().max().item()
        fail_if(failures, not err <= KERNEL_TOL, f"projected_attention_rect max |err| {err}")
        k_ms = time_ms(lambda: fused_projected_attention(*args))
        p_ms = time_ms(lambda: plain(*args))
        for form in ("bf16", "bf16a"):
            xb, kvb = to_bf16(xn), to_bf16(kv)
            wsb = [to_bf16(t) for t in ws] if form == "bf16" else ws
            args_b = (xb, kvb, *wsb, heads, kmask)
            got_b = fused_projected_attention(*args_b)
            twin = plain(*args_b)
            twin32 = plain(xb.float(), kvb.float(), *[t.float() for t in wsb], heads, kmask)
            cases[form] = gate_bf16(f"projected_attention_rect {form}", got_b, twin, twin32,
                                    plain(*on_cpu(args_b)), failures)
            cases[form]["ms"] = time_ms(lambda: fused_projected_attention(*args_b))
    flops = 2 * M * D * 3 * RECT_DOUT + 2 * 2 * N * heads * Tq * hd * hd
    nbytes = 4 * (2 * M * D + M * RECT_DOUT + M + 3 * RECT_DOUT * D + 3 * RECT_DOUT)
    b_ms, b_by, b_kind = bound(flops, nbytes)
    print(json.dumps({"phase": "parallel", "kernel": "projected_attention_rect",
                      "shape": [N, Tq, D, RECT_DOUT, heads], "tol": KERNEL_TOL,
                      "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bf16": cases,
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_us": b_ms * 1e3,
                      "bound_by": b_by, "bound_kind": b_kind}), flush=True)
    return {"name": "projected_attention_rect", "route": "cuda",
            "source": "hig_tpu_torch/csrc/projected_attention.cu",
            "replaces": "hig_tpu/ops/pallas_attention.py:116", "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_kind": b_kind, "library_ms": None}


def start_parallel_ranks(tmp: str) -> dict:
    """Phase 16's PAR_RANKS rank processes (``--parallel-rank``), with the
    phase's request and model files: each imports, joins the gloo group on
    cuda:0 and runs the cases. Started once phase 15 is over, so that no
    timed figure of an earlier phase shares the host with their start-up.
    Returns what phase_parallel and stop_parallel_ranks take."""
    import socket

    from hig_tpu_torch.data.vocab import CAPS

    # the ranks share the card with this process: hand back the blocks the
    # earlier phases left cached
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "parallel")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "par_model.json"), "w") as f:
        json.dump({"cap_id": True}, f)
    cap, lengths, _ = par_requests()
    with open(os.path.join(out, "par_requests.jsonl"), "w") as f:
        for (a, b), n in zip(cap, lengths):
            f.write(json.dumps({"caption1": CAPS[a], "caption2": CAPS[b],
                                "length": int(n) - 1}) + "\n")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    logs = [open(os.path.join(out, f"log{r}.txt"), "w") for r in range(PAR_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), port, out], stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=ROOT) for r in range(PAR_RANKS)]
    return {"out": out, "procs": procs, "logs": logs, "t_start": time.perf_counter(),
            "parent_gb": {"allocated": torch.cuda.memory_allocated() / 1e9,
                          "reserved": torch.cuda.memory_reserved() / 1e9}}


def stop_parallel_ranks(ranks: dict) -> None:
    """End the ranks (whether or not they finished) and close their logs."""
    for p in ranks["procs"]:
        p.kill()
        p.wait()
    for f in ranks["logs"]:
        if not f.closed:
            f.close()


def phase_parallel(device, failures, smi: str, ranks: dict) -> dict:
    """Phase 16 (see the module doc): B2's rectangular form alone, then the
    ranks of ``start_parallel_ranks`` on cuda:0 over gloo, each case against
    its one-rank counterpart, run here on the card while the ranks run.
    Returns the row of B2's rectangular form, its launches those of the TP
    call on rank 0."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.parallel.mesh import flax_leaves, shard_dims
    from hig_tpu_torch.train import trainer as tt

    t_phase = time.perf_counter()
    out, procs = ranks["out"], ranks["procs"]
    cap, lengths, _ = par_requests()
    t0 = ranks["t_start"]
    refs = {}
    try:
        # B2's rectangular form alone and the one-rank counterparts, on the
        # card while the ranks run
        row = check_projected_attention_rect(device, failures)
        trainer = tt.Trainer(par_cfg(out), device, graph=False)
        state = trainer.init_state()
        weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        refs["dp"] = par_steps(trainer, state, PAR_STEPS, device)
        model = trainer.init_state(weights).model.eval()
        del trainer, state, weights
        sample = tt.make_sampler(model, g.make_schedule(g.linear_betas(1000)), T, 263, "ddim",
                                 PAR_TP_STEPS, graph=False)
        refs["tp"] = sample(torch.from_numpy(cap), torch.from_numpy(lengths),
                            noise=torch.from_numpy(par_requests()[2])).cpu().numpy()
        del model, sample
        t1 = time.perf_counter()
        serve.main(par_serve_argv(out, os.path.join(out, "serve_one")))
        refs["serve_s"] = time.perf_counter() - t1
        refs["entry"] = par_entry_refs(out, device)
        refs_s = time.perf_counter() - t0
        for p in procs:
            p.wait(timeout=max(1.0, PAR_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_parallel_ranks(ranks)
    ranks_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if any(codes):
        for r in range(PAR_RANKS):
            print(open(os.path.join(out, f"log{r}.txt")).read()[-3000:], file=sys.stderr)
        fail_if(failures, True, f"parallel ranks exited {codes}")
        return {**row, "launches": 0}
    res = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(PAR_RANKS)]
    report = {"phase": "parallel", "nvidia_smi": smi, "ranks": PAR_RANKS,
              "note": "2 ranks on one card, gloo: times are not a DP speed",
              "ranks_s": ranks_s, "one_rank_refs_s": refs_s,
              "parent_gb_at_start": ranks["parent_gb"],
              "rank_parts_s": [r["parts_s"] for r in res]}
    fail_if(failures, any(r["backend"] != "gloo" or r["device"] != "cuda:0" for r in res),
            f"parallel: ranks on {[(r['backend'], r['device']) for r in res]}")

    # (a) DP: bitwise across ranks, against the one-rank eager step at batch 32
    one = refs["dp"]
    dp = [r["dp"] for r in res]
    rel = max(abs(a - b) / abs(b) for got, want in zip(dp[0]["metrics"], one["metrics"])
              for a, b in zip(got, want))
    report["dp"] = {"metrics": dp[0]["metrics"], "one_rank": one["metrics"], "rel_err": rel,
                    "step_s": [r["step_s"] for r in dp], "one_rank_step_s": one["step_s"],
                    "launches": [r["launches"] for r in dp], "one_rank_launches": one["launches"]}
    fail_if(failures, dp[0]["metrics"] != dp[1]["metrics"], f"parallel dp: ranks differ {dp}")
    fail_if(failures, not rel <= TRAIN_LOSS_TOL, f"parallel dp: vs one rank {rel}")
    fail_if(failures, any(r["launches"] != PAR_STEPS * LAUNCHES_PER_STEP for r in dp),
            f"parallel dp: B2 launches {[r['launches'] for r in dp]}")

    # (b) FSDP: shards as _leaf_spec, loss, gradients and weights as DP's
    fs = [r["fsdp"] for r in res]
    mcfg = tt.model_config(par_cfg(out))
    dims = shard_dims(mcfg, PAR_RANKS, "fsdp")
    bad_shards = []
    for name, (path, flax_shape) in flax_leaves(mcfg).items():
        if dims[name] is None:
            continue
        want_shape = list(flax_shape[::-1] if path[-1] == "kernel" else flax_shape)
        want_shape[dims[name]] //= PAR_RANKS
        if fs[0]["shards"].get(name, want_shape) != want_shape:
            bad_shards.append(name)
    fail_if(failures, bool(bad_shards) or not fs[0]["shards"],
            f"parallel fsdp: shards off _leaf_spec {bad_shards}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fs[0]["metrics"][0], dp[0]["metrics"][0]))
    report["fsdp"] = {**{k: fs[0][k] for k in ("metrics", "grad_live_err", "grad_zero_err",
                                               "update_err_lr", "moved", "step_s",
                                               "launches")},
                      "rel_err_vs_dp": rel, "shards": len(fs[0]["shards"])}
    fail_if(failures, fs[0]["metrics"] != fs[1]["metrics"], f"parallel fsdp: ranks differ {fs}")
    fail_if(failures, not rel <= TRAIN_LOSS_TOL, f"parallel fsdp: loss vs dp {rel}")
    fail_if(failures, not (fs[0]["grad_live_err"] <= TRAIN_GRAD_TOL
                           and fs[0]["grad_zero_err"] <= TRAIN_ZERO_GRAD_TOL),
            f"parallel fsdp: gradients vs dp {report['fsdp']}")
    fail_if(failures, not (fs[0]["update_err_lr"] <= PAR_UPDATE_TOL and fs[0]["moved"] > 0.5),
            f"parallel fsdp: weights vs dp {report['fsdp']}")
    fail_if(failures, fs[0]["launches"] != LAUNCHES_PER_STEP,
            f"parallel fsdp: B2 launches {fs[0]['launches']}")

    # (c) TP: against the one-rank projected call; B2's rectangular form only
    want = refs["tp"]
    got = np.load(os.path.join(out, "tp_ddim.npy"))
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    tp = [r["tp"] for r in res]
    report["tp"] = {"rel_err": rel, "call_s": [r["call_s"] for r in tp],
                    "launches_rect": [r["launches_rect"] for r in tp]}
    fail_if(failures, not (np.isfinite(got).all() and rel <= SAMPLER_REL_TOL),
            f"parallel tp: vs one rank {rel}")
    others = [{k: v for k, v in r["counts"].items() if v} for r in tp]
    fail_if(failures, any(r["launches_rect"] != LAUNCHES_PER_STEP * PAR_TP_STEPS or o for r, o in
                          zip(tp, others)),
            f"parallel tp: launches {report['tp']['launches_rect']}, others {others}")

    # (d) PP: loss and gradients as the sequential stack's
    pp = [r["pp"] for r in res]
    report["pp"] = {k: [r[k] for r in pp] for k in ("loss", "loss_seq", "grad_live_err",
                                                    "grad_zero_err", "step_s")}
    report["pp"]["launches"] = [r["launches"]["projected_attention"] for r in pp]
    fail_if(failures, any(abs(r["loss"] - r["loss_seq"]) > TRAIN_LOSS_TOL * abs(r["loss_seq"])
                          or r["grad_live_err"] > TRAIN_GRAD_TOL
                          or r["grad_zero_err"] > TRAIN_ZERO_GRAD_TOL for r in pp),
            f"parallel pp: vs the sequential stack {report['pp']}")
    # a stage: 4 of the 8 layers, 2 kernel blocks each, over 2 microbatches
    fail_if(failures, report["pp"]["launches"] != [8 // PAR_RANKS * 2 * 2] * PAR_RANKS,
            f"parallel pp: B2 launches {report['pp']['launches']}")

    # (e) serving: the primary's files against one-rank serving
    one_s = refs["serve_s"]
    errs = []
    for i in range(PAR_REQUESTS):
        a = np.load(os.path.join(out, "serve_dp", f"req{i}.npz"))["features"]
        b = np.load(os.path.join(out, "serve_one", f"req{i}.npz"))["features"]
        errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
    sv = [r["serve"] for r in res]
    b1 = [r["counts"]["fused_block"] for r in sv]
    report["serve"] = {"rel_err": max(errs), "call_s": [r["call_s"] for r in sv],
                       "one_rank_s": one_s, "fused_block_launches": b1}
    fail_if(failures, not max(errs) <= SAMPLER_REL_TOL, f"parallel serve: vs one rank {errs}")
    fail_if(failures, b1 != [LAUNCHES_PER_CALL] * PAR_RANKS,
            f"parallel serve: B1 launches {b1}")
    report.update(par_entry_checks(out, [r["entry_points"] for r in res], refs["entry"],
                                   failures))
    report["entry_parts_s"] = [r["entry_points"]["parts_s"] for r in res]
    report["seconds"] = time.perf_counter() - t_phase
    print(json.dumps(report), flush=True)
    row["launches"] = res[0]["tp"]["launches_rect"]
    return row


def rel_errs(got: list, want: list, keys: tuple) -> float:
    """The largest relative error of metrics lines ``got`` against ``want``
    over ``keys``, the lines in step order (both runs log every step)."""
    if len(got) != len(want) or not got:
        return float("inf")
    return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want) for k in keys)


def par_entry_checks(out: str, got: list, refs: dict, failures) -> dict:
    """Phase 16's (f), (g) and (h) against their one-rank counterparts."""
    from hig_tpu_torch.train.trainer import TRAIN_METRICS

    report = {}
    # (f) train_single: the replicated weights equal across ranks, rank 0's
    # losses as one rank's, B2 on the single model's 8 blocks a step
    single = [g["single"] for g in got]
    losses = read_metrics(os.path.join(out, "single_ranks", "t2m", "par_single"))
    rel = rel_errs(losses, refs["single"], ("loss_mot_rec",))
    b2 = [s["counts"]["projected_attention"] for s in single]
    report["train_single"] = {"steps": [s["steps"] for s in single], "rel_err": rel,
                              "losses": [x["loss_mot_rec"] for x in losses],
                              "weights_equal": single[0]["digest"] == single[1]["digest"],
                              "launches": b2}
    fail_if(failures, not report["train_single"]["weights_equal"]
            or any(s["steps"] != PAR_SINGLE_STEPS for s in single) or not rel <= TRAIN_LOSS_TOL,
            f"parallel train_single: {report['train_single']}")
    fail_if(failures, any(v != (ABLATION_PER_CALL * PAR_SINGLE_STEPS
                                if k == "projected_attention" else 0)
                          for s in single for k, v in s["counts"].items()),
            f"parallel train_single: launches {[s['counts'] for s in single]}")
    # (g) distillation: rank 0's stage as one rank's, each rank the teacher's
    # B1 and the student's B2 on its rows
    stage = read_metrics(got[0]["distill"]["stage"])
    rel = rel_errs(stage, refs["distill"], ("loss_distill", "grad_norm"))
    counts = [{k: v for k, v in g["distill"]["counts"].items() if v} for g in got]
    report["distill"] = {"steps": len(stage), "rel_err": rel, "launches": counts,
                         "loss_distill": [x["loss_distill"] for x in stage]}
    fail_if(failures, len(stage) != 1 or not rel <= TRAIN_LOSS_TOL,
            f"parallel distill: {report['distill']}")
    fail_if(failures, any(c != DISTILL_STEP_LAUNCHES for c in counts),
            f"parallel distill: launches {counts}, expected {DISTILL_STEP_LAUNCHES}")
    # (h) --pretrained under FSDP and TP: the gathered state bit for bit the
    # one-rank load's, the first step as one rank's and equal across ranks
    want = refs["pretrained"]
    for mode in PAR_PRETRAINED:
        cases = [g[f"pretrained_{mode}"] for g in got]
        rel = max(abs(a - b) / abs(b) for a, b in zip(cases[0]["metrics"], want["metrics"]))
        differ = sorted(k for k, v in want["digest"].items()
                        if any(c["digest"].get(k) != v for c in cases))
        report[f"pretrained_{mode}"] = {
            "mode": cases[0]["mode"], "tensors": len(want["digest"]), "differ": differ,
            "metrics": cases[0]["metrics"], "one_rank": want["metrics"], "rel_err": rel,
            "load_s": [c["load_s"] for c in cases], "one_rank_load_s": want["load_s"],
            "metric_names": list(TRAIN_METRICS)}
        fail_if(failures, cases[0]["mode"] != mode or bool(differ)
                or any(c["digest"].keys() != want["digest"].keys() for c in cases)
                or cases[0]["metrics"] != cases[1]["metrics"] or not rel <= TRAIN_LOSS_TOL,
                f"parallel pretrained {mode}: {report[f'pretrained_{mode}']}")
    return report


def trainer_dataset(cfg):
    from hig_tpu_torch.data.dataset import PairDataset, load_training_stats

    mean, std = load_training_stats(cfg)
    return PairDataset(cfg, mean, std, "train_sub.txt", times=cfg.times,
                       label_path=cfg.label_path, seed=cfg.seed)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hig_tpu_torch")):
        print(f"chip_smoke: no hig_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hig_tpu_torch import serve
    from hig_tpu_torch.models.interaction_model import ModelConfig

    failures: list = []
    seconds, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    smi = phase_device()
    device = torch.device("cuda")
    lap("device")
    phase_build()
    lap("build")
    rows = phase_kernels(device, failures)
    lap("kernels")
    configs = {"fused": ModelConfig(fused_blocks=True), "projected": ModelConfig(),
               "no_eff": ModelConfig(efficient=False)}
    models = {run: serve.build_model(cfg, device, random_init=0)
              for run, cfg in configs.items()}
    lap("weights")
    print(json.dumps({"phase": "weights", "seconds": seconds["weights"],
                      "params": {run: sum(p.numel() for p in m.parameters())
                                 for run, m in models.items()}}), flush=True)
    phase_denoiser(models, device, failures)
    lap("denoiser")
    launches, runs, eager = phase_serve(models, device, failures)
    lap("serve")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = os.path.join(tmp, "data")
        write_train_data(data)
        train_launches, train_runs, f32_pit = phase_train(device, failures, smi,
                                                          serve_requests(), data, tmp)
        lap("train")
        pipeline_launches, pipeline_runs = phase_pipeline(
            device, failures, smi, serve_requests(), data, tmp)
        lap("pipeline")
        eval_launches, eval_runs = phase_evaluate(device, failures, smi, data, tmp,
                                                  models["fused"])
        lap("evaluate")
        bf16_rows, bf16_runs = phase_bf16(models, device, failures, smi, tmp)
        lap("bf16")
        bf16_train_launches, bf16_train_runs, bf16_train_walls = phase_bf16_train(
            device, failures, smi, serve_requests(), data, tmp, f32_pit)
        lap("bf16_train")
        ablation_launches, b2_long = phase_ablations(device, failures, smi, data, tmp)
        lap("ablations")
        option_launches, option_runs = phase_options(device, failures, smi, data, tmp,
                                                     models["fused"].state_dict())
        lap("options")
        geometry_launches, b3_forms, lazy_row = phase_geometry(device, failures, smi, tmp)
        lap("geometry")
        rest_launches = phase_rest(device, failures, smi, data, tmp, models["fused"])
        lap("rest")
        ranks = start_parallel_ranks(tmp)
        try:
            rect_row = phase_parallel(device, failures, smi, ranks)
            lap("parallel")
        finally:
            stop_parallel_ranks(ranks)
        ablation_launches = merge_counts(ablation_launches, option_launches)
        ablation_launches = merge_counts(ablation_launches, geometry_launches)
        ablation_launches = merge_counts(ablation_launches, rest_launches)
        bf16_rows["efficient_attention_bf16"]["forms"] = b3_forms
        bf16_rows["projected_attention_bf16"].update(b2_long)
        for form, row in bf16_rows.items():
            row["launches"] += bf16_train_launches.get(form, 0) + ablation_launches.get(form, 0)
        runs.update({**train_runs, **pipeline_runs, **eval_runs, **bf16_runs, **option_runs})
        runs.update({run: (call, bf16_train_walls[run]) for run, call in bf16_train_runs.items()})
        phase_profile(runs, eager, device, failures)
        lap("profile")
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)

    for name, row in rows.items():
        row["launches"] = (launches[name] + train_launches[name] + pipeline_launches[name]
                           + eval_launches[name] + ablation_launches.get(name, 0))
    rows.update(bf16_rows)
    lazy_row["launches"] = bf16_train_launches.get(LAZY_FORM, 0)
    rows[LAZY_FORM] = lazy_row
    rows["projected_attention_rect"] = rect_row
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(smi, flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase 16's ranks
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
