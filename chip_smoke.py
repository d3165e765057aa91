"""Chip check of the PyTorch/CUDA port (avid_cma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi), builds the CUDA
   kernels from avid_cma_tpu_torch/csrc/ and prints the build time;
2. holds each kernel (K1 spectrogram, K2/K3 stem pool fwd/bwd, K4 NCE
   gather, K5 fused (2+1)D conv pair) against its plain PyTorch version on
   the card at the shapes of the Kinetics slices (K5 at the four R2Plus1D-18
   stage shapes) and of the eval paths (K2/K3 on the 32at16 finetune's
   3.3 GB stem, its first and last images and da/db over all of it; K5
   at the four stage shapes at 64 and 128 clips, the clip test's and the
   probe's batches; K2/K3's f32 forms, for ``model.dtype: float32``, at
   both stem shapes, the 32at16 one 6.6 GB in f32), and times kernel and
   plain version with CUDA events
   (K1's, K2's and K3's launches also apart, as device intervals in a
   torch.profiler trace; beside K1, cuBLAS's f32 product of its DFT's
   shape as a reference; K3's da/db must be the same bits on two calls).
   Beside K5 in bf16, ``ref_cudnn_bf16_ms``: the two bf16 cuDNN
   convolutions the eval module would run without K5 (a yardstick only).
   K4 is timed as its device interval with cold bank rows: a ring of
   NCE_RING index draws, more rows than L2 holds, cycled across
   launches; its CUDA-event time on one warm draw, the wrapper's host
   cost per call, and ``index_select`` of the same cold rows (a reference
   only) are printed beside it. K4 also at the AVID-CMA index shapes:
   K = 32 (the positives) and K = 64 (a contiguous copy of the first 64
   columns of a 1024-column draw, the within-modal negatives);
3. runs one train step, and one eval-mode forward, at a small size on the
   card and on the CPU from the same weights and inputs and compares loss,
   Z and bank rows, and the embeddings; the train step again with
   ``model.dtype: float32`` (loss and Z within 1e-4 of the CPU's, the
   updated stem parameters too wherever Adam's step direction is settled,
   the stem's gradients through K3's f32 form those through its plain
   version, the f32 stem kernels launched); then the
   AVID-CMA positive set of
   small random banks mined on both (equal), and one AVID-CMA train step
   on both from the same weights, banks, positive set and negatives;
4. runs the Kinetics Cross-N1024 AVID pretraining slice at full width
   (R2Plus1D-18 + Conv2D-10, 32 clips of 8 x 224^2, 2 s audio, N = 232,067
   bank rows, 1024 negatives) through ``build_pretrain`` and the fused
   step: one warm-up step, then 5 timed steps with the launch counters
   reset just before them; checks finite losses, a frozen Z > 0, unit-norm
   touched bank rows, and that each kernel ran on that path; prints the
   step's device-busy ms (torch.profiler);
5. runs the forward-only slice of the same model through ``build_eval``:
   raw 240 x 320 frames through the eval preprocessing, one warm-up eval
   step, 5 timed ones with the counters reset just before them, then one
   embed call; checks finite losses, a state left bit for bit as it was,
   reproducible losses per batch index, and the launches of each kernel
   (K5 on the 13 stride-1 pairs of every forward); prints K5's device ms
   per eval step and the step's device-busy ms (torch.profiler);
6. runs one ``crop+color`` train preprocessing of the train slice's raw
   frames with the jitter in a random per-clip order (non-identity
   permutations) on the card (f32, and bf16 as the train path runs it)
   and on the CPU (f32) from the same draws, and holds them together;
7. drives the pretraining entry point, ``run_pretraining``, from
   ``configs/main/avid/kinetics/Cross-N1024.yaml`` at full width through
   the port's synthetic data layer, the threaded loader and the device
   prefetch (160 clips, 32 a step, one clip per video: 5 train steps and 5
   test steps through K5 an epoch), then again with ``resume=true`` and two
   epochs: checks finite losses, the resume at epoch 1, step 5, the end at
   step 10, unit-norm bank rows in the checkpoint, a ``.pth.tar`` export and
   import that give back the same bits, and each kernel's launches over the
   two runs (counters reset just before the first); prints train clips/s
   per epoch, the loader-wait share, the device's idle share over the
   second run's traced steps (the loop's ``profile_steps`` window), the
   peak memory and the launches;
8. runs the AVID-CMA slice (``kinetics_cma()``: the same model and batch,
   1024 negatives, 64 within, the top-32 consensus positives): mines the
   full positive set of N = 232,067 random unit-norm bank rows on the card
   (its seconds), holds 256 random rows of it against a CPU sweep of those
   rows against the full banks (equal, except rows whose k-th and
   (k+1)-th agreement lie within MINING_TIE of each other in f64), checks
   every row (sorted, unique, in range, no self), then one warm-up and 5
   timed fused CMA train steps with the counters reset before the timed
   ones: finite losses, a frozen Z > 0, unit-norm touched rows, no drawn
   negative inside its row's positive set, each kernel's launches; prints
   clips/s, peak memory and the step's device-busy ms;
9. drives ``run_pretraining`` on the Kinetics AVID-CMA YAML with the loop
   phase's overrides, warm-started (model, banks and Z) from the loop
   phase's AVID run directory and re-mining every epoch: one epoch, then a
   resume to two; checks finite losses, Z equal bit for bit to the AVID
   run's, that the first run mined and the resumed one re-mined at epoch
   1, a valid positive set in the last checkpoint, and each kernel's
   launches over the two runs; prints clips/s per epoch, the loader-wait
   share and the mining seconds;
10. runs the eval paths at a small size (R2Plus1D-10, 8 clips of 8 x
   64^2) on the card and on the CPU from the same weights: a
   classifier-only warmup step (the backbone frozen: its parameters the
   same bits, its BN stats moved), a finetune step and a probe step over
   four pooled taps (the extractor the same bits), each loss within 2% of
   the CPU's and each step's K2/K3/K5 launches as expected; the finetune
   step's update is Adam's step on every backbone parameter, its stem
   gradients on the card equal those through K3's plain version, and its
   backbone gradient points the CPU's f32 way as far as bf16 allows;
11. runs the eval slices from their YAMLs at their batch sizes, raw
   frames at the configs' decode size (256 x 342) on the card, random
   R2Plus1D-18 weights: ``ucf/8at16-fold1.yaml`` (b64, 101 classes,
   dropout 0.5) for 1 + 5 warmup steps and 1 + 5 finetune steps, then a
   clip-test forward; ``ucf/32at16-fold1.yaml`` for 1 + 2 finetune steps at
   b64 x 32 frames; ``kinetics/8x224x224-linear.yaml`` (b128, crop+color,
   four taps, 400 classes) for 1 + 5 probe steps. Each: finite losses,
   the launches a step (warmup K2 1, K3 0, K5 0; finetune 1, 1, 0; test
   forward and probe 1, 0, 13, so the frozen extractor builds no backward
   and runs K5 in a training loop), the extractor unchanged; prints
   clips/s, the device-busy ms a step, the peak memory;
12. drives the eval entry points chained from the loop phase's AVID run:
   ``run_action_recognition`` on the 8at16 YAML (a synthetic corpus of 8
   videos, batch 16, one warmup and one finetune epoch, the 25-clip final
   test, the dense eval) and ``run_linear_probe`` on the linear YAML (8
   videos, batch 8, one epoch, the dense eval), each again with
   ``test_only`` (the same accuracies); checks that each loaded the AVID
   run's video model bit for bit and each kernel's launches over the four
   runs (each run's one-clip eval forward that sizes its heads included);
13. runs the f32 AVID learning proof (``scripts/learning_proof.py``: the
   learnable synthetic corpus through ``run_pretraining``, then
   retrieval on unseen instances and the ridge probe) at PROOF_EPOCHS
   epochs: the probe gate, and each kernel's launches (the f32 forms of
   K2/K3 only, none of the bf16 ones); then, from that f32 run, the
   finetune and the probe entry points and ``classify`` with
   ``model.dtype: float32`` (the f32 stem forms and K5 launched, no bf16
   K2/K3);
14. distributed pretraining, each phase in a one-rank NCCL world brought
   up by the port's ``parallel.mesh`` (the card host has one card; the
   cross-rank logic is held to the JAX package by the CPU tests over two
   gloo ranks), the group destroyed after each phase:
   a. the row-sharded primitives at AudioSet size (N = 1,784,108, D =
      128, 32 clips, 1024 negatives): ``scores_sharded`` (forward and
      dq) equal to direct ``gather_scores`` bit for bit, through one K4
      launch; ``ema_update_rows_sharded`` equal to the replicated
      update; both timed beside their replicated forms;
   b. ``configs/main/avid/audioset/Cross-N1024.yaml`` from the entry
      point, ``pretrain_main([..., "--multihost"])`` with torchrun's
      environment for one rank, at full width with its sharded banks of
      N = 1,784,108 rows (a synthetic corpus of N videos, 32 clips a
      rank, epochs cut to LOOP_STEPS steps, no test phase): one epoch and
      a resume; then the same with ``bank_sharding=replicated`` and no
      process group. Under cuDNN's deterministic algorithms (both runs),
      the per-step losses, the final banks, Z and every parameter and
      BN stat must be the same bits; the checkpoint holds 1,784,108-row
      banks; each kernel's launches;
   c. the Kinetics AVID-CMA YAML with ``loss.bank_sharding=sharded``,
      chained from the loop phase's AVID run: one epoch; its positive
      set (the row-sharded sweep's) equal to ``mine_positives`` of the
      AVID run's banks, except at near-ties; and the row-sharded sweep
      against ``mine_positives`` at N = 232,067 random unit rows;
15. prints one JSON line per check, a summary line per slice, the
   ``{"kernels": [...]}`` line (launches: the AVID loop phase's, the
   eval loops', the learning proof's, the f32 evals' and the
   distributed phases') and, last, ``{"ok": true, "device": ...}``.

Every phase runs under the backend state the entry points set
(``prepare_device``: TF32 off, cuDNN autotuning on), set before the
first, and raises on failure; nothing is caught. Without a CUDA card the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.cli import pretrain_main
from avid_cma_tpu_torch.criterions import avid_cma, mining
from avid_cma_tpu_torch.criterions.avid import AVIDConfig, BankState, _last_occurrence
from avid_cma_tpu_torch.criterions.nce import l2_normalize
from avid_cma_tpu_torch.data.pipelines import preprocess_batch
from avid_cma_tpu_torch.device import prepare_device
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper, init_params
from avid_cma_tpu_torch.models.blocks import BatchNorm
from avid_cma_tpu_torch.models.eval_wrappers import (
    ClassificationWrapper,
    MOSTModel,
    classifier_parameters,
)
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.ops import stft, video_aug
from avid_cma_tpu_torch.ops.sampling import rank_shift
from avid_cma_tpu_torch.parallel import mesh, sharding
from avid_cma_tpu_torch.ops.kernels import (
    _lib,
    nce_gather,
    r2p1d_pair,
    spectrogram,
    stem_pool,
)
from avid_cma_tpu_torch.scripts import classify, learning_proof
from avid_cma_tpu_torch.scripts.r2p1d_block_bench import cudnn_bf16_pair, cudnn_weights
from avid_cma_tpu_torch.train import builders, eval_loop
from avid_cma_tpu_torch.train.builders import (
    build_eval,
    build_pretrain,
    kinetics_cma,
    kinetics_cross_n1024,
)
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_pth_tar,
    import_criterion_pth_tar,
    import_criterion_run,
    import_model_pth_tar,
    import_model_run,
    import_optimizer_pth_tar,
)
from avid_cma_tpu_torch.train.loop import run_pretraining
from avid_cma_tpu_torch.train.optim import build_from_config, build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import make_embed_fn, make_train_step

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s off the
# tensor cores, dense bf16 FLOP/s on the tensor cores (K5's bound in bf16:
# the least time the card could take for bf16 products)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

WARMUP_STEPS, TIMED_STEPS = 1, 5
# the slice's shapes at the kernels: waveforms (B, L); the stem activation
# (B*T, 112, 112, 64); the bank rows; the raw decoded frame size of the JAX
# package's benchmark (short side 8/7 of the crop)
AUDIO_SHAPE = (32, 48000)
STEM_SHAPE = (256, 112, 112, 64)
BANK_ROWS = 232067
RAW_HW = (256, 320)
# the eval slice's raw frames: a common Kinetics source size, so the eval
# short-side resize (240 -> 256) really resizes
EVAL_RAW_HW = (240, 320)
# K4's cold-row ring: 8 draws of 32 x 1024 rows of 512 bytes (134 MB) cycle
# through the 50 MB L2, as fresh negatives do on the main path
NCE_RING = 8
# the stride-1 (2+1)D pairs of R2Plus1D-18 at 8 x 224^2, 32 clips: (B, T, H, W, C)
PAIR_SHAPES = {"conv2x": (32, 8, 56, 56, 64), "conv3x": (32, 4, 28, 28, 128),
               "conv4x": (32, 2, 14, 14, 256), "conv5x": (32, 1, 7, 7, 512)}
# the eval paths' batches at those pairs: the finetune's clip-test forward
# (64 clips) and the linear probe's frozen extractor (128 clips)
EVAL_PAIR_SHAPES = {f"{name} b{b}": (b, *shape[1:])
                    for b in (64, 128) for name, shape in PAIR_SHAPES.items()}
# the 32at16 finetune's stem activation, 64 clips x 32 frames: 3.3 GB of
# bf16, past 2^31 bytes, so a 32-bit offset would wrap in its last images.
# The plain versions' f32 temporaries do not fit at that size: they run on
# chunks of STEM_CHUNK images.
STEM_SHAPE_32AT16 = (64 * 32, 112, 112, 64)
STEM_CHUNK = 128

KERNELS = {
    "spectrogram": dict(
        name="K1 spectrogram", source="avid_cma_tpu_torch/csrc/spectrogram.cu",
        replaces="avid_cma_tpu/ops/pallas/spectrogram.py:120"),
    "stem_pool_fwd": dict(
        name="K2 stem_pool_fwd", source="avid_cma_tpu_torch/csrc/stem_pool.cu",
        replaces="avid_cma_tpu/ops/pallas/stem_pool.py:247"),
    "stem_pool_bwd": dict(
        name="K3 stem_pool_bwd", source="avid_cma_tpu_torch/csrc/stem_pool.cu",
        replaces="avid_cma_tpu/ops/pallas/stem_pool.py:272"),
    "stem_pool_fwd_f32": dict(
        name="K2 stem_pool_fwd f32", source="avid_cma_tpu_torch/csrc/stem_pool.cu",
        replaces="avid_cma_tpu/ops/pallas/stem_pool.py:247"),
    "stem_pool_bwd_f32": dict(
        name="K3 stem_pool_bwd f32", source="avid_cma_tpu_torch/csrc/stem_pool.cu",
        replaces="avid_cma_tpu/ops/pallas/stem_pool.py:272"),
    "nce_gather": dict(
        name="K4 nce_gather", source="avid_cma_tpu_torch/csrc/nce_gather.cu",
        replaces="avid_cma_tpu/ops/pallas/nce_gather.py:113"),
    "r2p1d_pair": dict(
        name="K5 r2p1d_pair", source="avid_cma_tpu_torch/csrc/r2p1d_pair_mma.cu",
        replaces="avid_cma_tpu/ops/pallas/r2p1d_block.py:84"),
}
# the f32 forms of K2/K3 run only where model.dtype is float32: in the f32
# step check, the learning-proof phase and the f32 evals; every bf16 path
# launches none
NO_F32_STEM = {"stem_pool_fwd_f32": 0, "stem_pool_bwd_f32": 0}
EXPECTED_LAUNCHES = {"spectrogram": 5, "stem_pool_fwd": 5, "stem_pool_bwd": 5,
                     "nce_gather": 20, "r2p1d_pair": 0, **NO_F32_STEM}
# 5 eval steps: one spectrogram, one stem pool and 4 score launches each,
# and K5 on the 13 stride-1 pairs of each forward; one embed call
EXPECTED_EVAL_LAUNCHES = {"spectrogram": 5, "stem_pool_fwd": 5, "stem_pool_bwd": 0,
                          "nce_gather": 20, "r2p1d_pair": 65, **NO_F32_STEM}
EXPECTED_EMBED_LAUNCHES = {"spectrogram": 0, "stem_pool_fwd": 1, "stem_pool_bwd": 0,
                           "nce_gather": 0, "r2p1d_pair": 13, **NO_F32_STEM}
# the loop phase: Cross-N1024 from its YAML on the synthetic data layer. One
# clip per video (the recipe takes 10), so 160 clips give 5 steps of 32.
REPO = os.path.dirname(os.path.abspath(__file__))
LOOP_CONFIG = os.path.join(REPO, "configs/main/avid/kinetics/Cross-N1024.yaml")
LOOP_OVERRIDES = ["dataset.backend=synthetic", "dataset.synthetic_size=160",
                  "dataset.batch_size=32", "dataset.train.clips_per_video=1",
                  "optimizer.num_epochs=1", "log2tb=false", "num_workers=4"]
LOOP_STEPS = 5  # train steps an epoch, and test steps an epoch
# two runs of one epoch each: per train step one spectrogram, one stem pool
# forward and backward, 4 score launches; per test step one spectrogram,
# one stem pool forward, 4 score launches and K5 on the 13 stride-1 pairs
EXPECTED_LOOP_LAUNCHES = {"spectrogram": 4 * LOOP_STEPS, "stem_pool_fwd": 4 * LOOP_STEPS,
                          "stem_pool_bwd": 2 * LOOP_STEPS, "nce_gather": 16 * LOOP_STEPS,
                          "r2p1d_pair": 26 * LOOP_STEPS, **NO_F32_STEM}
# the distributed phases. AudioSet's recipe: N = 1,784,108 bank rows, 32
# clips a rank (its 256 over 8 GPUs). The synthetic corpus has N videos so
# that the banks have N rows; its epochs are cut to LOOP_STEPS steps (160
# clips), with no test phase (the test split would hold N videos too).
AUDIOSET_CONFIG = os.path.join(REPO, "configs/main/avid/audioset/Cross-N1024.yaml")
AUDIOSET_ROWS = 1784108
# the AudioSet phase, per layout: two runs of one epoch, 4 score launches
# a train step (sharded: one K4 launch per score call, on the rank's shard)
AUDIOSET_OVERRIDES = ["dataset.backend=synthetic", f"dataset.synthetic_size={AUDIOSET_ROWS}",
                      "dataset.batch_size=32", f"steps_per_epoch={LOOP_STEPS}",
                      "no_test=true", "optimizer.num_epochs=1", "log2tb=false",
                      "num_workers=4", "print_freq=1"]
EXPECTED_AUDIOSET_LAUNCHES = {"spectrogram": 2 * LOOP_STEPS, "stem_pool_fwd": 2 * LOOP_STEPS,
                              "stem_pool_bwd": 2 * LOOP_STEPS, "nce_gather": 8 * LOOP_STEPS,
                              "r2p1d_pair": 0, **NO_F32_STEM}
# AVID-CMA: 8 score launches a step (inst-v2a and inst-a2v: the self row
# and the negatives; pos-v2v and pos-a2a: the positives and the first 64
# negatives), against AVID's 4
EXPECTED_CMA_LAUNCHES = {"spectrogram": 5, "stem_pool_fwd": 5, "stem_pool_bwd": 5,
                         "nce_gather": 40, "r2p1d_pair": 0, **NO_F32_STEM}
CMA_LOOP_CONFIG = os.path.join(REPO, "configs/main/avid-cma/kinetics/"
                                     "InstX-N1024-PosW-N64-Top32.yaml")
EXPECTED_CMA_LOOP_LAUNCHES = {"spectrogram": 4 * LOOP_STEPS, "stem_pool_fwd": 4 * LOOP_STEPS,
                              "stem_pool_bwd": 2 * LOOP_STEPS, "nce_gather": 32 * LOOP_STEPS,
                              "r2p1d_pair": 26 * LOOP_STEPS, **NO_F32_STEM}
# the sharded CMA phase: one run of one epoch (5 train and 5 test steps)
EXPECTED_CMA_SHARDED_LAUNCHES = {k: v // 2 for k, v in EXPECTED_CMA_LOOP_LAUNCHES.items()}
# the action-recognition evals from their YAMLs: the UCF-101 full finetune
# at 8 and 32 frames (batch 64) and the Kinetics-400 linear probe (batch
# 128), raw frames at the configs' decode_size
UCF_8AT16 = os.path.join(REPO, "configs/benchmark/ucf/8at16-fold1.yaml")
UCF_32AT16 = os.path.join(REPO, "configs/benchmark/ucf/32at16-fold1.yaml")
KINETICS_LINEAR = os.path.join(REPO, "configs/benchmark/kinetics/8x224x224-linear.yaml")
STEPS_32AT16 = 2  # timed 32at16 finetune steps, after one untimed
BATCH_32AT16 = 64  # the recipe's batch
# launches a step of (K2, K3, K5): a warmup step builds no backward through
# the frozen backbone; a finetune step runs the stem's forward and backward
# in training mode (no K5); an eval-mode forward (the clip and dense tests,
# and every probe step's frozen extractor) runs K5 on its 13 stride-1 pairs
PER_STEP = {"warmup": (1, 0, 0), "finetune": (1, 1, 0), "test": (1, 0, 13),
            "probe": (1, 0, 13)}
# the eval loops, chained from the loop phase's AVID run: a small synthetic
# corpus, one warmup and one finetune epoch; the probe for one epoch
FT_VIDEOS, FT_BATCH, FT_TRAIN_CLIPS = 8, 16, 2
PROBE_VIDEOS, PROBE_BATCH = 8, 8
FT_LOOP_OVERRIDES = ["dataset.backend=synthetic", f"dataset.synthetic_size={FT_VIDEOS}",
                     f"dataset.batch_size={FT_BATCH}",
                     f"dataset.train.clips_per_video={FT_TRAIN_CLIPS}",
                     "optimizer.num_epochs=1", "optimizer.warmup_epochs=1", "num_workers=4"]
PROBE_LOOP_OVERRIDES = ["dataset.backend=synthetic", f"dataset.synthetic_size={PROBE_VIDEOS}",
                        f"dataset.batch_size={PROBE_BATCH}", "optimizer.num_epochs=1",
                        "num_workers=4"]
# mining, card against CPU: a row may differ only where its k-th and
# (k+1)-th agreement, recomputed in f64, lie closer than this (the two sum
# the f32 products in other orders)
MINING_TIE = 1e-6
MINING_SAMPLE_ROWS = 256
# crop+color against the CPU's f32 from the same draws. In f32 the card
# differs only in summation order: 1e-4, the CPU parity gate. In bf16 the
# hue op sets the bound: h * 6 rounds to 2^-5 in [4, 6), so a channel moves
# by up to v * s * 2^-6 = 0.016, and with h's own rounding (6 * 2^-9) and
# the shift's about 0.04 in [0, 1]; in a random order up to three ops
# follow the hue and each scales a deviation by up to 1.4 (2.74 in all):
# 0.11, or 0.49 after the ImageNet std (0.225), plus the resize's and the
# other ops' roundings (about 0.002 each in [0, 1]): 0.6. The mean stays
# near the resize's one-level rounding, 1/255/0.225 = 0.017.
# the small finetune step's backbone gradient, card (bf16) against CPU
# (f32): bf16 rounding flips the max pools' choices on near-ties and
# reroutes the gradient, so the CPU's own bf16 backbone reaches a cosine
# of only 0.82-0.96 (by layer) with its f32 one at this size (measured
# on the card host's CPU); a wrong or missing gradient gives about 0
GRAD_COS_BF16 = 0.75
CROP_COLOR_TOL = {"f32_max_abs": 1e-4, "bf16_max_abs": 0.6, "bf16_mean_abs": 0.02}
# the f32 AVID step, card against CPU: ROADMAP's one-step parity gates
# (the parameters' on the elements whose step direction is settled)
F32_STEP_TOL = {"loss_rel": 1e-4, "z_rel": 1e-4, "stem_param_max_abs": 1e-4}
# the learning-proof phase: the f32 AVID proof at the JAX script's
# defaults but PROOF_EPOCHS epochs, not 400 (2.3 s an epoch on the H100
# with its per-epoch test phase and checkpoint, so about 15 min in all: the
# full proofs are recorded by their own runs); gated on the probe, which
# clears its gate within 8 epochs; retrieval is printed, not gated (it
# needs the full run)
PROOF_EPOCHS = 16
PROOF_K5_PER_FORWARD = 5  # stride-1 pairs of R2Plus1D-10


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events), after
    one untimed call."""
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


def launch_split_ms(fn, names, iters: int = 10) -> dict:
    """Device ms per call of each kernel that fn() launches, by the name it
    contains: the kernels' intervals in a torch.profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                split[n] += (e.time_range.end - e.time_range.start) / 1e3 / iters
    return split


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(results: dict, key: str, case: str, abs_err: float, err: float, tol: float,
           kernel_fn, plain_fn, nbytes: float, flops: float, iters: int = 20,
           peak_flops: float = F32_FLOPS, device_ms: float = None, extra: dict = None) -> None:
    """Time kernel and plain version, print the check's JSON line, raise if
    ``err`` exceeds ``tol``; keep the first case's times and the largest
    absolute error over the cases for the kernels line. The kernel's time
    is its CUDA-event time over ``iters`` calls of ``kernel_fn``, unless
    ``device_ms`` gives another reading (the event time is then printed
    as ``event_ms``)."""
    ms = time_ms(kernel_fn, iters)
    line = {}
    if device_ms is not None:
        line["event_ms"] = ms
        ms = device_ms
    plain = time_ms(plain_fn, max(3, iters // 4))
    b_ms, b_by = bound(nbytes, flops, peak_flops)
    name = KERNELS[key]["name"]
    print(json.dumps({"name": name, "case": case, "max_err": err, "tol": tol,
                      "max_abs_err": abs_err, "kernel_ms": ms, **line, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      **(extra or {})}), flush=True)
    require(err <= tol, f"{name} ({case}): error {err} > {tol}")
    r = results.setdefault(key, {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                                 "bound_by": b_by, "max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)


def check_spectrogram(results: dict) -> None:
    # noise with a DC offset, and a loud tone over a noise floor followed by
    # near-silence (the top_db clamp bites). Bins whose power nearly cancels
    # (a zero-mean frame's DC bin, a pure tone's far sidelobes) are
    # ill-conditioned in any f32 DFT, so the signals keep every bin above
    # the clamp well away from cancellation.
    rng = np.random.default_rng(0)
    b, n = AUDIO_SHAPE
    t = np.arange(n) / 24000.0
    sig = 0.1 * rng.standard_normal((b, n)) + 0.05
    loud = np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal((b // 2, n)) + 0.05
    sig[b // 2:] = np.where(t < 1.0, loud, 1e-7 * rng.standard_normal((b // 2, n)))
    x = torch.from_numpy(sig.astype(np.float32)).cuda()
    kw = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=2.0)
    got = spectrogram.log_spectrogram_kernel(x, **kw)
    ref = stft.log_spectrogram(x, **kw)
    frames = stft.num_frames(n, 240, 2.0, 0.01)
    require(got.shape == ref.shape == (b, frames, 257, 1), f"K1 shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    flops = 2.0 * b * frames * 1024 * 513 * 2
    nbytes = x.numel() * 4 + got.numel() * 4 + 2 * 1024 * 513 * 4 + 1024 * 4 + 2 * 257 * 4
    report(results, "spectrogram", f"{b} x {n}", err, err, 1e-4,
           lambda: spectrogram.log_spectrogram_kernel(x, **kw),
           lambda: stft.log_spectrogram(x, **kw), nbytes, flops)
    split = launch_split_ms(lambda: spectrogram.log_spectrogram_kernel(x, **kw),
                            ("stft_power_kernel", "db_clamp_norm_kernel"))
    # reachability reference, never called by the port: the DFT's f32
    # product alone, (B*T, frame_len) @ (frame_len, 2 * 513), TF32 off
    fa = torch.randn((b * frames, 1024), device="cuda")
    fb = torch.randn((1024, 2 * 513), device="cuda")
    print(json.dumps({"name": KERNELS["spectrogram"]["name"], "launch_ms": split,
                      "ref_sgemm_ms": time_ms(lambda: torch.matmul(fa, fb), 20),
                      "ref_sgemm_shape": [list(fa.shape), list(fb.shape)]}), flush=True)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    av = v.float().abs()
    e = torch.floor(torch.log2(torch.where(av > 0, av, torch.ones_like(av))))
    return torch.where(av > 0, torch.exp2(e - 7), torch.full_like(av, 2.0 ** -133))


def check_stem_pool(results: dict) -> None:
    rng = np.random.default_rng(1)
    n, h, w, c = STEM_SHAPE
    base = torch.from_numpy(rng.standard_normal(STEM_SHAPE, dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((n, h // 2, w // 2, c), dtype=np.float32)
                         ).cuda().to(torch.bfloat16)
    a_r = torch.from_numpy((rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)).cuda()
    b_r = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32)).cuda()
    g32 = torch.from_numpy(rng.standard_normal((n, h // 2, w // 2, c), dtype=np.float32)).cuda()
    cases = {
        "random": (base.to(torch.bfloat16), a_r, b_r),
        # values on a 0.5 grid: ties in most windows
        "tie-heavy": (torch.round(base * 2.0).div(2.0).to(torch.bfloat16),
                      torch.ones_like(a_r), torch.zeros_like(b_r)),
    }
    # the f32 forms (model.dtype: float32): the same draws in f32, off the
    # bf16 grid, and the same ties
    f32_cases = {
        "f32 random": (base, a_r, b_r),
        "f32 tie-heavy": (torch.round(base * 2.0).div(2.0), torch.ones_like(a_r),
                          torch.zeros_like(b_r)),
    }
    del base
    n_in, n_out = n * h * w * c, n * (h // 2) * (w // 2) * c
    for case, (y, a, b) in cases.items():
        out = stem_pool.stem_pool_fwd(y, a, b)
        ref = stem_pool.plain_fwd(y, a, b)
        err = float((out.float() - ref.float()).abs().max())
        split = launch_split_ms(lambda: stem_pool.stem_pool_fwd(y, a, b),
                                ("stem_pool_fwd_kernel",))
        report(results, "stem_pool_fwd", case, err, err, 0.0,
               lambda: stem_pool.stem_pool_fwd(y, a, b),
               lambda: stem_pool.plain_fwd(y, a, b),
               n_in * 2 + n_out * 2 + 2 * c * 4, 0.0, extra={"launch_ms": split})

        dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
        _, da2, db2 = stem_pool.stem_pool_bwd(y, a, b, g)
        same_bits = bool(torch.equal(da, da2) and torch.equal(db, db2))
        rdy, rda, rdb = stem_pool.plain_bwd(y, a, b, g)
        diff = (dy.float() - rdy.float()).abs()
        ulps = float((diff / _bf16_ulp(rdy)).max())
        err = float(diff.max())
        rel_a = float((da - rda).abs().max() / rda.abs().max())
        rel_b = float((db - rdb).abs().max() / rdb.abs().max())
        split = launch_split_ms(lambda: stem_pool.stem_pool_bwd(y, a, b, g),
                                ("stem_pool_bwd_kernel", "stem_pool_bwd_sum_kernel"))
        print(json.dumps({"name": "K3 stem_pool_bwd", "case": case, "da_rel": rel_a,
                          "db_rel": rel_b, "tol": 2e-3, "da_db_same_bits_twice": same_bits,
                          "launch_ms": split}), flush=True)
        require(max(rel_a, rel_b) <= 2e-3, f"K3 ({case}): da/db off by {rel_a}, {rel_b}")
        require(same_bits, f"K3 ({case}): da/db differ between two calls")
        # max_err: dy in bf16 ulps of the plain value
        report(results, "stem_pool_bwd", case, err, ulps, 1.0,
               lambda: stem_pool.stem_pool_bwd(y, a, b, g),
               lambda: stem_pool.plain_bwd(y, a, b, g),
               n_in * 2 * 2 + n_out * 2 + 4 * c * 4, 0.0, iters=10)
    del cases
    for case, (y, a, b) in f32_cases.items():
        check_stem_pool_f32(results, case, y, a, b, g32)


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / float(ref.abs().max())


def check_stem_pool_f32(results: dict, case: str, y, a, b, g) -> None:
    """K2 and K3's f32 forms against their plain versions on the same
    inputs: the output within 1e-6 of the largest (same math, so it is
    exact in practice), dy within 1e-6, da and db within 1e-5, da/db the
    same bits on two calls."""
    n, h, w, c = y.shape
    n_in, n_out = n * h * w * c, n * (h // 2) * (w // 2) * c
    err, rel = _max_rel(stem_pool.stem_pool_fwd(y, a, b), stem_pool.plain_fwd(y, a, b))
    split = launch_split_ms(lambda: stem_pool.stem_pool_fwd(y, a, b),
                            ("stem_pool_fwd_f32_kernel",))
    report(results, "stem_pool_fwd_f32", case, err, rel, 1e-6,
           lambda: stem_pool.stem_pool_fwd(y, a, b), lambda: stem_pool.plain_fwd(y, a, b),
           n_in * 4 + n_out * 4 + 2 * c * 4, 0.0, extra={"launch_ms": split})

    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    _, da2, db2 = stem_pool.stem_pool_bwd(y, a, b, g)
    same_bits = bool(torch.equal(da, da2) and torch.equal(db, db2))
    rdy, rda, rdb = stem_pool.plain_bwd(y, a, b, g)
    err, rel = _max_rel(dy, rdy)
    del dy, rdy
    rel_a, rel_b = _max_rel(da, rda)[1], _max_rel(db, rdb)[1]
    split = launch_split_ms(lambda: stem_pool.stem_pool_bwd(y, a, b, g),
                            ("stem_pool_argmax_f32_kernel", "stem_pool_bwd_f32_kernel",
                             "stem_pool_bwd_f32_sum_kernel"))
    print(json.dumps({"name": KERNELS["stem_pool_bwd_f32"]["name"], "case": case,
                      "da_rel": rel_a, "db_rel": rel_b, "tol": 1e-5,
                      "da_db_same_bits_twice": same_bits, "launch_ms": split}), flush=True)
    require(max(rel_a, rel_b) <= 1e-5, f"K3 f32 ({case}): da/db off by {rel_a}, {rel_b}")
    require(same_bits, f"K3 f32 ({case}): da/db differ between two calls")
    report(results, "stem_pool_bwd_f32", case, err, rel, 1e-6,
           lambda: stem_pool.stem_pool_bwd(y, a, b, g),
           lambda: stem_pool.plain_bwd(y, a, b, g),
           n_in * 4 * 2 + n_out * 4 + 4 * c * 4, 0.0, iters=10)


def check_stem_pool_32at16(results: dict) -> None:
    """K2 and K3 at the 32at16 finetune's stem (STEM_SHAPE_32AT16). The
    first and the last two images against the plain versions (K2 exact,
    dy within one bf16 ulp, as ``check_stem_pool``); da and db against the
    plain versions' sums over every chunk of STEM_CHUNK images (2e-3 of
    the largest). ``plain_ms`` is the chunked sweep over every image."""
    n, h, w, c = STEM_SHAPE_32AT16
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(STEM_SHAPE_32AT16, generator=gen, device="cuda", dtype=torch.bfloat16)
    g = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda", dtype=torch.bfloat16)
    a = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    require(y.numel() * y.element_size() > 2**31, "the 32at16 stem is under 2^31 bytes")
    chunks = [slice(i, min(i + STEM_CHUNK, n)) for i in range(0, n, STEM_CHUNK)]
    ends = (slice(0, 2), slice(n - 2, n))
    case = f"32at16 stem {list(STEM_SHAPE_32AT16)}, first and last 2 images"
    extra = {"plain_ms_is": f"the plain version over {len(chunks)} chunks of {STEM_CHUNK} images"}
    n_in, n_out = n * h * w * c, n * (h // 2) * (w // 2) * c

    out = stem_pool.stem_pool_fwd(y, a, b)
    err = max(float((out[r].float() - stem_pool.plain_fwd(y[r], a, b).float()).abs().max())
              for r in ends)
    del out
    report(results, "stem_pool_fwd", case, err, err, 0.0,
           lambda: stem_pool.stem_pool_fwd(y, a, b),
           lambda: [stem_pool.plain_fwd(y[r], a, b) for r in chunks],
           n_in * 2 + n_out * 2 + 2 * c * 4, 0.0, iters=5, extra=extra)

    def plain_sums():
        parts = [stem_pool.plain_bwd(y[r], a, b, g[r])[1:] for r in chunks]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)

    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    err = ulps = 0.0
    for r in ends:
        rdy = stem_pool.plain_bwd(y[r], a, b, g[r])[0]
        diff = (dy[r].float() - rdy.float()).abs()
        err, ulps = max(err, float(diff.max())), max(ulps, float((diff / _bf16_ulp(rdy)).max()))
    del dy
    rda, rdb = plain_sums()
    rel_a = float((da - rda).abs().max() / rda.abs().max())
    rel_b = float((db - rdb).abs().max() / rdb.abs().max())
    print(json.dumps({"name": "K3 stem_pool_bwd", "case": case, "da_rel": rel_a,
                      "db_rel": rel_b, "tol": 2e-3}), flush=True)
    require(max(rel_a, rel_b) <= 2e-3, f"K3 ({case}): da/db off by {rel_a}, {rel_b}")
    # max_err: dy in bf16 ulps of the plain value
    report(results, "stem_pool_bwd", case, err, ulps, 1.0,
           lambda: stem_pool.stem_pool_bwd(y, a, b, g), plain_sums,
           n_in * 2 * 2 + n_out * 2 + 4 * c * 4, 0.0, iters=3, extra=extra)
    del y, g
    torch.cuda.empty_cache()
    check_stem_pool_32at16_f32(results, gen, a, b, chunks, ends, extra)


def check_stem_pool_32at16_f32(results: dict, gen, a, b, chunks, ends, extra) -> None:
    """K2 and K3's f32 forms at the 32at16 stem in f32 (6.6 GB, three
    times past 2^31 bytes): the first and last two images against the
    plain versions (K2 within 1e-6 of the largest, dy within 1e-6), da and
    db against the plain versions' sums over every chunk (1e-5)."""
    n, h, w, c = STEM_SHAPE_32AT16
    y = torch.randn(STEM_SHAPE_32AT16, generator=gen, device="cuda")
    g = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda")
    require(y.numel() * y.element_size() > 3 * 2**31, "the f32 32at16 stem is under 6 GiB")
    case = f"f32 32at16 stem {list(STEM_SHAPE_32AT16)}, first and last 2 images"
    n_in, n_out = n * h * w * c, n * (h // 2) * (w // 2) * c

    out = stem_pool.stem_pool_fwd(y, a, b)
    err, rel = 0.0, 0.0
    for r in ends:
        e, q = _max_rel(out[r], stem_pool.plain_fwd(y[r], a, b))
        err, rel = max(err, e), max(rel, q)
    del out
    report(results, "stem_pool_fwd_f32", case, err, rel, 1e-6,
           lambda: stem_pool.stem_pool_fwd(y, a, b),
           lambda: [stem_pool.plain_fwd(y[r], a, b) for r in chunks],
           n_in * 4 + n_out * 4 + 2 * c * 4, 0.0, iters=5, extra=extra)

    def plain_sums():
        parts = [stem_pool.plain_bwd(y[r], a, b, g[r])[1:] for r in chunks]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)

    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    err, rel = 0.0, 0.0
    for r in ends:
        e, q = _max_rel(dy[r], stem_pool.plain_bwd(y[r], a, b, g[r])[0])
        err, rel = max(err, e), max(rel, q)
    del dy
    rda, rdb = plain_sums()
    rel_a, rel_b = _max_rel(da, rda)[1], _max_rel(db, rdb)[1]
    print(json.dumps({"name": KERNELS["stem_pool_bwd_f32"]["name"], "case": case,
                      "da_rel": rel_a, "db_rel": rel_b, "tol": 1e-5}), flush=True)
    require(max(rel_a, rel_b) <= 1e-5, f"K3 f32 ({case}): da/db off by {rel_a}, {rel_b}")
    report(results, "stem_pool_bwd_f32", case, err, rel, 1e-6,
           lambda: stem_pool.stem_pool_bwd(y, a, b, g), plain_sums,
           n_in * 4 * 2 + n_out * 4 + 4 * c * 4, 0.0, iters=3, extra=extra)


def check_nce_gather(results: dict) -> None:
    """K4 at K = 1024 (negatives) and K = 1 (the positive), and at the
    AVID-CMA shapes K = 32 (the positives) and K = 64 (the within-modal
    negatives: a contiguous copy of a 1024-column draw's first 64
    columns, as ``cma_forward`` passes them). Its time is its
    device interval over a ring of NCE_RING index draws cycled across
    launches, so the rows are cold in L2 as on the main path (fresh
    negatives every step, from a 119 MB bank); the bound counts the unique
    rows of a draw, averaged over the ring. Printed beside it: the
    CUDA-event time of the wrapper on one draw (its rows warm in L2), the
    wrapper's host cost per call (host clock over calls that do not wait
    for the card), and ``ref_gather_ms``, ``index_select`` of the same cold
    rows: a reachability reference, never called by the port."""
    rng = np.random.default_rng(2)
    n, d, bsz = BANK_ROWS, 128, AUDIO_SHAPE[0]
    bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda(), dim=1)
    q = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((bsz, d), dtype=np.float32)).cuda(), dim=1)
    for k, cols in ((1024, 1024), (1, 1), (32, 32), (64, 1024)):
        ring = [torch.from_numpy(rng.integers(0, n, (bsz, cols))).cuda()[:, :k].contiguous()
                for _ in range(NCE_RING)]
        abs_err = rel = 0.0
        for idx in ring:
            got = nce_gather.scores(bank, idx, q, 0.07)
            ref = nce_gather.plain_scores(bank, idx, q, 0.07)
            e = float((got - ref).abs().max())
            abs_err, rel = max(abs_err, e), max(rel, e / float(ref.abs().max()))
        def cold(fn):
            draws = itertools.cycle(ring)
            return lambda: fn(next(draws))

        iters = 4 * NCE_RING
        dev_ms = launch_split_ms(cold(lambda i: nce_gather.scores(bank, i, q, 0.07)),
                                 ("nce_scores_kernel",), iters)["nce_scores_kernel"]
        # every device interval of the call (one gather kernel)
        gather_ms = launch_split_ms(cold(lambda i: bank.index_select(0, i.flatten())),
                                    ("",), iters)[""]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            nce_gather.scores(bank, ring[0], q, 0.07)
        host_us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        rows = sum(int(torch.unique(i).numel()) for i in ring) / NCE_RING
        nbytes = rows * d * 4 + bsz * k * 8 + q.numel() * 4 + bsz * k * 4
        idx = ring[0]
        # max_err: relative to the largest score
        case = f"K={k}" if k == cols else f"K={k} (first {k} of {cols} columns, contiguous)"
        report(results, "nce_gather", case, abs_err, rel, 1.3e-5,
               lambda: nce_gather.scores(bank, idx, q, 0.07),
               lambda: nce_gather.plain_scores(bank, idx, q, 0.07),
               nbytes, 2.0 * bsz * k * d, device_ms=dev_ms,
               extra={"kernel_ms_is": f"device interval, cold rows (ring of {NCE_RING})",
                      "event_ms_is": "CUDA events around the wrapper, one draw (warm rows)",
                      "wrapper_host_us": host_us, "unique_rows": rows})
        print(json.dumps({"name": KERNELS["nce_gather"]["name"], "case": case,
                          "ref_gather_ms": gather_ms,
                          "ref_gather_call": "bank.index_select(0, idx.flatten()), cold rows"}),
              flush=True)


def _taps(n: int) -> int:
    """(position, tap) pairs of a 3-tap SAME conv over n positions that
    touch real input: the taps on the zero padding are no work."""
    return 3 * n - 2 if n > 1 else 1


def check_r2p1d_pair(results: dict) -> None:
    """K5 at the four stage shapes in bf16, at conv2x's in f32, and in bf16
    at the eval paths' batches (EVAL_PAIR_SHAPES).
    Tolerance, max |kernel - plain| / max |plain|: 8e-3 in bf16, two ulps
    at the output's scale (the kernel and cuDNN sum in other orders, and
    the rounding of the bf16 intermediate can flip); 1e-5 in f32."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [(name, shape, torch.bfloat16) for name, shape in PAIR_SHAPES.items()]
    cases.append(("conv2x f32", PAIR_SHAPES["conv2x"], torch.float32))
    cases += [(name, shape, torch.bfloat16) for name, shape in EVAL_PAIR_SHAPES.items()]
    for case, shape, dtype in cases:
        b, t, h, w, c = shape
        x = randn(*shape).to(dtype)
        ws = (randn(1, 3, 3, c, c) / (9 * c) ** 0.5).to(dtype)
        wt = (randn(3, 1, 1, c, c) / (3 * c) ** 0.5).to(dtype)
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = randn(c) * 0.1
        got = r2p1d_pair.r2p1d_pair(x, ws, wt, scale, bias).float()
        ref = r2p1d_pair.plain_pair(x, ws, wt, scale, bias).float()
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        del got, ref
        es = x.element_size()
        flops = 2.0 * b * c * c * (t * _taps(h) * _taps(w) + h * w * _taps(t))
        nbytes = 2 * x.numel() * es + 12 * c * c * es + 2 * c * 4
        bf16 = dtype == torch.bfloat16
        # the yardstick in bf16: the two cuDNN convolutions the eval module
        # would run without K5 (never called by the port for K5's work)
        extra = {}
        if bf16:
            cw = cudnn_weights(ws, wt)
            extra["ref_cudnn_bf16_ms"] = time_ms(lambda: cudnn_bf16_pair(x, *cw, scale, bias), 10)
            plan = r2p1d_pair.plan_bf16(
                *shape, torch.cuda.get_device_properties(0).multi_processor_count)
            extra["plan"] = {k: getattr(plan, k) for k in ("tile_h", "frames", "smem_bytes", "grid")}
        report(results, "r2p1d_pair", f"{case} {list(shape)}", abs_err, rel,
               8e-3 if bf16 else 1e-5,
               lambda: r2p1d_pair.r2p1d_pair(x, ws, wt, scale, bias),
               lambda: r2p1d_pair.plain_pair(x, ws, wt, scale, bias),
               nbytes, flops, iters=10, peak_flops=BF16_FLOPS if bf16 else F32_FLOPS,
               extra=extra)


def check_small_step() -> None:
    """One train step at a small size on the card (bf16 convolutions, the
    kernels) and on the CPU (f32, the plain versions, which the CPU tests
    hold to the JAX package) from the same weights, banks, batch and
    negatives. bf16 rounding through 10 layers moves the loss by a few
    parts in a thousand; a wrong layout or kernel moves it by far more."""
    rng = np.random.default_rng(4)
    n, k, b = 256, 64, 8
    batch = {"frames": rng.standard_normal((b, 8, 64, 64, 3), dtype=np.float32),
             "audio": rng.standard_normal((b, 40, 257, 1), dtype=np.float32),
             "index": rng.choice(n, b, replace=False)}
    negs = rng.integers(0, n, (b, k))
    banks = rng.standard_normal((2, n, 128), dtype=np.float32)
    banks /= np.linalg.norm(banks, axis=2, keepdims=True)
    crit = AVIDConfig(num_data=n, num_negatives=k, momentum=0.5)
    out = {}
    for dev in ("cpu", "cuda"):
        model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                           proj_dim=[512, 512, 128], seed=0, device=dev)
        opt = build_optimizer(model.parameters(), "adam", 2e-4, weight_decay=1e-5)
        bank = BankState(*(torch.from_numpy(m.copy()).to(dev) for m in banks),
                         z=torch.tensor(-1.0, device=dev))
        state = TrainState(model, opt, multistep_scheduler(opt, [], 1.0), bank,
                           torch.Generator(device=dev))
        m = make_train_step(crit)(
            state, {key: torch.from_numpy(v).to(dev) for key, v in batch.items()},
            neg_idx=torch.from_numpy(negs).to(dev))
        rows = state.bank.view2_mem[torch.from_numpy(batch["index"]).to(dev)].cpu()
        out[dev] = (float(m["loss"]), float(state.bank.z), rows)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    z_rel = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    cos = float((out["cuda"][2] * out["cpu"][2]).sum(1).min())
    print(json.dumps({"name": "small step, card vs CPU", "loss_cuda": out["cuda"][0],
                      "loss_cpu": out["cpu"][0], "loss_rel": loss_rel, "z_rel": z_rel,
                      "min_bank_row_cos": cos, "tol": {"loss_rel": 2e-2, "z_rel": 2e-2,
                                                       "min_bank_row_cos": 0.99}}), flush=True)
    require(loss_rel <= 2e-2 and z_rel <= 2e-2 and cos >= 0.99,
            f"small step: card and CPU disagree (loss {loss_rel}, Z {z_rel}, cos {cos})")


def check_small_step_f32() -> None:
    """One AVID train step with ``model.dtype: float32`` on the card (f32
    convolutions, the f32 forms of K2/K3) and on the CPU from the same
    weights, banks, batch and negatives. The batch is the same
    preprocessed tensors on both (the fused step draws its augmentation
    from a generator of the batch's device, whose streams differ).

    Gates (F32_STEP_TOL, ROADMAP's one-step parity): the loss and Z within
    1e-4 of the CPU's; the updated stem conv weight and stem BN weight and
    bias within 1e-4 wherever the step's direction is settled. Adam's
    first step moves each element by lr * g / (|g| + eps), about lr times
    the sign of g, so an element whose gradient lies closer to 0 than the
    card's and the CPU's gradients are to each other may step either way:
    those may differ by up to 2 lr (the max pools route a gradient to the
    first of near-equal values, and the card's convolutions round
    differently, so a few windows route elsewhere). On the card, the
    stem's gradients through K3's f32 form equal those through its plain
    version within 1e-5 (the same forward), and the step launches the f32
    stem kernels once each and no bf16 form."""
    rng = np.random.default_rng(8)
    n, k, b, lr = 256, 64, 8, 2e-4
    batch = {"frames": rng.standard_normal((b, 8, 64, 64, 3), dtype=np.float32),
             "audio": rng.standard_normal((b, 40, 257, 1), dtype=np.float32),
             "index": rng.choice(n, b, replace=False)}
    negs = rng.integers(0, n, (b, k))
    banks = rng.standard_normal((2, n, 128), dtype=np.float32)
    banks /= np.linalg.norm(banks, axis=2, keepdims=True)
    crit = AVIDConfig(num_data=n, num_negatives=k, momentum=0.5)

    def step(dev):
        model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                           proj_dim=[512, 512, 128], seed=0, device=dev, dtype="float32")
        opt = build_optimizer(model.parameters(), "adam", lr, weight_decay=1e-5)
        bank = BankState(*(torch.from_numpy(m.copy()).to(dev) for m in banks),
                         z=torch.tensor(-1.0, device=dev))
        state = TrainState(model, opt, multistep_scheduler(opt, [], 1.0), bank,
                           torch.Generator(device=dev))
        _lib.reset_launches()
        m = make_train_step(crit)(
            state, {key: torch.from_numpy(v).to(dev) for key, v in batch.items()},
            neg_idx=torch.from_numpy(negs).to(dev))
        stem = [p for m_ in model.video_model.conv1 for p in m_.parameters()]
        return {"loss": float(m["loss"]), "z": float(state.bank.z),
                "params": [p.detach().cpu() for p in stem],
                "grads": [p.grad.cpu() for p in stem], "launches": dict(_lib.LAUNCHES)}

    cpu, card = step("cpu"), step("cuda")
    with plain_stem_backward():
        twin = step("cuda")
    want = {**dict.fromkeys(_lib.LAUNCHES, 0), "stem_pool_fwd_f32": 1, "stem_pool_bwd_f32": 1,
            "nce_gather": 4}
    require(card["launches"] == want, f"f32 step launched {card['launches']}, expected {want}")
    require(not any(cpu["launches"].values()), f"the CPU step launched {cpu['launches']}")
    settled_err, unsettled_err, unsettled, over_tol = 0.0, 0.0, 0, 0
    for p, q, g, h in zip(card["params"], cpu["params"], card["grads"], cpu["grads"]):
        diff = (p - q).abs()
        over_tol += int((diff > F32_STEP_TOL["stem_param_max_abs"]).sum())
        settled = h.abs() > (g - h).abs().max()
        if bool(settled.any()):
            settled_err = max(settled_err, float(diff[settled].max()))
        if not bool(settled.all()):
            unsettled_err = max(unsettled_err, float(diff[~settled].max()))
            unsettled += int((~settled).sum())
    line = {"name": "small f32 step, card vs CPU", "loss_cuda": card["loss"],
            "loss_cpu": cpu["loss"], "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "z_rel": abs(card["z"] - cpu["z"]) / abs(cpu["z"]),
            "stem_param_max_abs": settled_err,
            "stem_param_max_abs_all": max(settled_err, unsettled_err),
            "unsettled_elements": unsettled, "unsettled_max_abs": unsettled_err,
            "elements_over_tol": over_tol,
            "stem_params": sum(p.numel() for p in cpu["params"]),
            "stem_grad_rel_vs_cpu": [_max_rel(g, h)[1] for g, h in zip(card["grads"],
                                                                        cpu["grads"])],
            "stem_grad_rel_k3_vs_plain": [_max_rel(g, h)[1] for g, h in zip(card["grads"],
                                                                             twin["grads"])],
            "launches_cuda": card["launches"], "tol": F32_STEP_TOL}
    print(json.dumps(line), flush=True)
    for key, tol in F32_STEP_TOL.items():
        require(line[key] <= tol, f"small f32 step: {key} {line[key]} > {tol}")
    require(unsettled_err <= 2 * lr + F32_STEP_TOL["stem_param_max_abs"],
            f"small f32 step: an unsettled element moved {unsettled_err}, more than 2 lr")
    require(max(line["stem_grad_rel_k3_vs_plain"]) <= 1e-5,
            f"the stem's gradients through K3 f32 and through its plain version differ "
            f"({line['stem_grad_rel_k3_vs_plain']})")


def proof_launches(args) -> dict:
    """Each kernel's launches in the f32 AVID learning proof of ``args``:
    per epoch the train steps (K1, K2, K3 f32, 4 x K4) and the test phase
    over the test split of train-size items (K1, K2 f32, 4 x K4, K5 on
    every stride-1 pair), then the three extractions (NCE space of the
    test instances: K1, K2, K5; pool taps of the train and the test
    instances: K2, K5)."""
    e, bs = args.epochs, args.batch
    train, test = args.train_size // bs, -(-args.train_size // bs)
    nce, taps = -(-args.test_size // bs), -(-args.train_size // bs) + -(-args.test_size // bs)
    return {**dict.fromkeys(_lib.LAUNCHES, 0),
            "spectrogram": e * (train + test) + nce,
            "stem_pool_fwd_f32": e * (train + test) + nce + taps,
            "stem_pool_bwd_f32": e * train,
            "nce_gather": 4 * e * (train + test),
            "r2p1d_pair": PROOF_K5_PER_FORWARD * (e * test + nce + taps)}


def run_learning_proof(model_dir: str) -> dict:
    """The f32 AVID learning proof (``scripts/learning_proof.py``: the
    learnable synthetic corpus through ``run_pretraining``, then
    retrieval on unseen instances and the ridge probe) at PROOF_EPOCHS
    epochs, the launch counters reset just before it: the probe gate, the
    launches of each kernel (the f32 stem forms only, no bf16 one)."""
    args = learning_proof.build_argparser().parse_args(
        ["--epochs", str(PROOF_EPOCHS), "--model-dir", model_dir, "--device", "cuda"])
    os.makedirs(model_dir, exist_ok=True)
    with loop_log(os.path.join(model_dir, "proof_stdout.log"), "learning proof"):
        _lib.reset_launches()
        record = learning_proof.run_proof(args)
        torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    want = proof_launches(args)
    require(launches == want, f"learning proof launched {launches}, expected {want}")
    require(record["compute_dtype"] == "float32", f"proof computed {record['compute_dtype']}")
    require(record["pass_probe"], f"learning proof: probe top-1 {record['probe_top1']} under "
            f"{args.probe_factor} x chance {record['chance_top1']}")
    return {**record, "gated": ["pass_probe"], "launches": launches}


def run_f32_evals(proof_dir: str) -> dict:
    """The eval entry points and ``classify`` with ``model.dtype:
    float32`` on the card, from the learning-proof phase's f32 AVID run
    (R2Plus1D-10) in ``proof_dir``: ``run_action_recognition`` on the
    8at16 YAML and ``run_linear_probe`` on the linear YAML with the eval
    loops' overrides, then ``classify_videos`` of two synthetic files
    from the finetune's best checkpoint. Accuracies in range, one
    probability distribution a file; the launches, counters reset just
    before: the f32 stem forms and K5, no bf16 K2/K3, no K1 or K4."""
    mcfg = config_lib.load(os.path.join(proof_dir, "learning-proof", "config.yaml")).model
    require(mcfg.get("dtype") == "float32", f"the proof's run has model.dtype {mcfg.get('dtype')}")
    runs = (("finetune", eval_loop.run_action_recognition, UCF_8AT16, FT_LOOP_OVERRIDES),
            ("probe", eval_loop.run_linear_probe, KINETICS_LINEAR, PROBE_LOOP_OVERRIDES))
    out = {}
    with loop_log(os.path.join(proof_dir, "f32_evals_stdout.log"), "f32 evals"):
        _lib.reset_launches()
        for name, run, path, overrides in runs:
            t0 = time.perf_counter()
            res = run(config_lib.load(path, overrides), mcfg, fold=1, device="cuda")
            torch.cuda.synchronize()
            out[name] = {"results": res, "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        probs, kind = classify.classify_videos(config_lib.load(UCF_8AT16, FT_LOOP_OVERRIDES), mcfg,
                                               ["f32_a.mp4", "f32_b.mp4"], fold=1, clips=2,
                                               device="cuda")
        out["classify"] = {"checkpoint": kind, "top1": probs.argmax(1).tolist(),
                           "s": time.perf_counter() - t0}
        launches = dict(_lib.LAUNCHES)
    flat = list(out["finetune"]["results"].values()) + [
        x for tap in out["probe"]["results"].values() for x in tap.values()]
    require(all(0.0 <= v <= 100.0 for v in flat), f"f32 eval accuracies {flat}")
    require(kind == "checkpoints_best" and probs.shape == (2, 101) and np.isfinite(probs).all()
            and float(np.abs(probs.sum(1) - 1).max()) < 1e-5,
            f"classify: {kind}, probabilities {probs.shape}, sums {probs.sum(1)}")
    require(launches["stem_pool_fwd"] == launches["stem_pool_bwd"] == 0
            and launches["spectrogram"] == launches["nce_gather"] == 0,
            f"the f32 evals launched {launches}")
    require(min(launches["stem_pool_fwd_f32"], launches["stem_pool_bwd_f32"],
                launches["r2p1d_pair"]) > 0, f"the f32 evals launched {launches}")
    return {**out, "launches": launches}


def check_small_eval() -> None:
    """One eval-mode forward at a small size (depth 10, B=8, 8 x 64^2) on
    the card (bf16 convolutions, K5 on the five stride-1 pairs) and on the
    CPU (f32, the plain versions) from the same weights and BN running
    stats (drawn from a seed, so the folded scale and bias are not
    trivial); every embedding within cosine 0.99."""
    rng = np.random.default_rng(5)
    b = 8
    video = rng.standard_normal((b, 8, 64, 64, 3), dtype=np.float32)
    audio = rng.standard_normal((b, 40, 257, 1), dtype=np.float32)
    embs = {}
    for dev in ("cpu", "cuda"):
        model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                           proj_dim=[512, 512, 128], seed=0, device=dev)
        stats = np.random.default_rng(6)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(torch.from_numpy(stats.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(stats.uniform(0.5, 1.5, c).astype(np.float32)))
        before = _lib.LAUNCHES["r2p1d_pair"]
        v, a = make_embed_fn(model)(torch.from_numpy(video).to(dev),
                                    torch.from_numpy(audio).to(dev))
        embs[dev] = (v.float().cpu(), a.float().cpu())
        launched = _lib.LAUNCHES["r2p1d_pair"] - before
        require(launched == (5 if dev == "cuda" else 0), f"K5 launches on {dev}: {launched}")
    cos = [float(torch.nn.functional.cosine_similarity(g, r, dim=1).min())
           for g, r in zip(embs["cuda"], embs["cpu"])]
    print(json.dumps({"name": "small eval forward, card vs CPU", "min_video_emb_cos": cos[0],
                      "min_audio_emb_cos": cos[1], "tol": 0.99}), flush=True)
    require(min(cos) >= 0.99, f"small eval forward: card and CPU disagree (cos {cos})")


def check_positive_set(pos: torch.Tensor, n: int, pos_k: int, rows=None) -> None:
    """Every row of a mined positive set (of the bank rows ``rows``, all
    by default) sorted ascending and so unique, in [0, n), without its own
    index."""
    rows = torch.arange(pos.shape[0]) if rows is None else rows.cpu()
    pos = pos.cpu()
    require(tuple(pos.shape) == (rows.shape[0], pos_k) and pos.dtype == torch.int64,
            f"positive set {tuple(pos.shape)} {pos.dtype}")
    require(bool((pos[:, 1:] > pos[:, :-1]).all()), "positive set rows not sorted and unique")
    require(int(pos.min()) >= 0 and int(pos.max()) < n, "positive set index out of range")
    require(not bool((pos == rows[:, None]).any()), "a positive set row holds its own index")


def mining_disagreement(card: torch.Tensor, cpu: torch.Tensor, bank_v, bank_a,
                        rows: torch.Tensor, pos_k: int, kind: str) -> dict:
    """Card's against CPU's mining of the bank rows ``rows``: equal, except
    rows whose k-th and (k+1)-th agreement lie within MINING_TIE in f64."""
    differ = (card.cpu() != cpu.cpu()).any(dim=1).nonzero().flatten()
    gaps = (mining.boundary_gap(bank_v, bank_a, rows.cpu()[differ], pos_k, kind)
            if differ.numel() else torch.zeros(0, dtype=torch.float64))
    out = {"rows_compared": int(rows.shape[0]), "rows_differing": int(differ.numel()),
           "max_boundary_gap_of_differing_rows": float(gaps.max()) if gaps.numel() else None,
           "tie_tol": MINING_TIE}
    require(not bool((gaps >= MINING_TIE).any()),
            f"mining: card and CPU pick other sets away from a near-tie ({out})")
    return out


def check_small_cma_step() -> None:
    """The AVID-CMA positive set of small random banks mined on the card
    and on the CPU (equal), then one AVID-CMA train step at a small size on
    each from the same weights, banks, positive set and negatives (drawn
    past the positives): loss and Z within 2%, the touched bank rows
    within cosine 0.99, as the AVID step's check."""
    rng = np.random.default_rng(7)
    n, k, within, pos_k, b = 256, 64, 16, 8, 8
    banks = rng.standard_normal((2, n, 128), dtype=np.float32)
    banks /= np.linalg.norm(banks, axis=2, keepdims=True)
    pos = {dev: mining.mine_positives(*(torch.from_numpy(m).to(dev) for m in banks), pos_k).cpu()
           for dev in ("cpu", "cuda")}
    require(torch.equal(pos["cuda"], pos["cpu"]), "small mining: card and CPU sets differ")
    check_positive_set(pos["cpu"], n, pos_k)
    batch = {"frames": rng.standard_normal((b, 8, 64, 64, 3), dtype=np.float32),
             "audio": rng.standard_normal((b, 40, 257, 1), dtype=np.float32),
             "index": rng.choice(n, b, replace=False)}
    y = torch.from_numpy(batch["index"])
    negs = rank_shift(torch.from_numpy(rng.integers(0, n - pos_k, (b, k))), pos["cpu"][y])
    crit = avid_cma.AVIDCMAConfig(num_data=n, num_negatives=k, num_negatives_within=within,
                                  pos_k=pos_k)
    out = {}
    for dev in ("cpu", "cuda"):
        model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                           proj_dim=[512, 512, 128], seed=0, device=dev)
        opt = build_optimizer(model.parameters(), "adam", 2e-4, weight_decay=1e-5)
        bank = avid_cma.CMAState(*(torch.from_numpy(m.copy()).to(dev) for m in banks),
                                 z=torch.tensor(-1.0, device=dev),
                                 positive_set=pos["cpu"].to(dev))
        state = TrainState(model, opt, multistep_scheduler(opt, [], 1.0), bank,
                           torch.Generator(device=dev))
        m = make_train_step(crit)(
            state, {key: torch.from_numpy(v).to(dev) for key, v in batch.items()},
            neg_idx=negs.to(dev))
        out[dev] = (float(m["loss"]), float(state.bank.z), state.bank.view2_mem[y.to(dev)].cpu())
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    z_rel = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    cos = float((out["cuda"][2] * out["cpu"][2]).sum(1).min())
    print(json.dumps({"name": "small AVID-CMA mining and step, card vs CPU",
                      "positive_sets_equal": True, "loss_cuda": out["cuda"][0],
                      "loss_cpu": out["cpu"][0], "loss_rel": loss_rel, "z_rel": z_rel,
                      "min_bank_row_cos": cos, "tol": {"loss_rel": 2e-2, "z_rel": 2e-2,
                                                       "min_bank_row_cos": 0.99}}), flush=True)
    require(loss_rel <= 2e-2 and z_rel <= 2e-2 and cos >= 0.99,
            f"small CMA step: card and CPU disagree (loss {loss_rel}, Z {z_rel}, cos {cos})")


def run_slice() -> dict:
    cfg = kinetics_cross_n1024()
    state, fused = build_pretrain(cfg, device="cuda")
    rng = np.random.default_rng(0)
    b, t = cfg.batch_size, cfg.num_frames
    raw = {
        "frames": torch.from_numpy(
            rng.integers(0, 255, (b, t, *RAW_HW, 3), dtype=np.uint8)).cuda(),
        "audio": torch.from_numpy(
            rng.standard_normal((b, int(cfg.audio_clip_duration * cfg.audio_fps)),
                                dtype=np.float32)).cuda(),
        "index": torch.from_numpy(rng.choice(cfg.num_data, b, replace=False)).cuda(),
    }
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS):
        fused(state, raw, i)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    z0 = float(state.bank.z)
    require(z0 > 0, f"Z not frozen after the first step: {z0}")

    _lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [fused(state, raw, WARMUP_STEPS + i)["loss"] for i in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)

    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"non-finite loss {losses.tolist()}")
    require(float(state.bank.z) == z0, "Z changed after it was frozen")
    for mem in (state.bank.view1_mem, state.bank.view2_mem):
        norms = torch.linalg.vector_norm(mem[raw["index"]], dim=1)
        require(float((norms - 1).abs().max()) < 1e-5, "touched bank rows not unit norm")
        require(mem.shape == (cfg.num_data, 128), f"bank shape {tuple(mem.shape)}")
    require(launches == EXPECTED_LAUNCHES,
            f"kernel launches on the main path {launches}, expected {EXPECTED_LAUNCHES}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # every device interval of a step (one stream, so their sum is the
    # busy time), to hold the AVID-CMA slice's against
    busy = launch_split_ms(lambda: fused(state, raw, 100), ("",), iters=3)[""]
    return {
        "losses": losses.tolist(), "z": z0, "warmup_s": warmup_s,
        "step_ms": dt / TIMED_STEPS * 1e3, "clips_per_sec": b * TIMED_STEPS / dt,
        "peak_mem_gib": peak, "launches": launches, "device_busy_ms_per_step": busy,
    }


def _snapshot(state: TrainState) -> list:
    return ([state.bank.view1_mem.clone(), state.bank.view2_mem.clone(), state.bank.z.clone()]
            + [v.clone() for v in state.model.state_dict().values()])


def run_eval_slice() -> dict:
    cfg = kinetics_cross_n1024()
    state, fused_eval, embed = build_eval(cfg, device="cuda")
    rng = np.random.default_rng(1)
    b, t = cfg.batch_size, cfg.num_frames
    raw = {
        "frames": torch.from_numpy(
            rng.integers(0, 255, (b, t, *EVAL_RAW_HW, 3), dtype=np.uint8)).cuda(),
        "audio": torch.from_numpy(
            rng.standard_normal((b, int(cfg.audio_clip_duration * cfg.audio_fps)),
                                dtype=np.float32)).cuda(),
        "index": torch.from_numpy(rng.choice(cfg.num_data, b, replace=False)).cuda(),
    }
    before = _snapshot(state)
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS):
        fused_eval(state, raw, i)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    _lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [fused_eval(state, raw, i)["loss"] for i in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"non-finite eval loss {losses.tolist()}")
    again = float(fused_eval(state, raw, 0)["loss"])
    require(again == float(losses[0]), f"batch 0 gave {again}, then {float(losses[0])}")
    require(float(losses[0]) != float(losses[1]), "batches 0 and 1 drew the same negatives")
    require(launches == EXPECTED_EVAL_LAUNCHES,
            f"kernel launches on the eval path {launches}, expected {EXPECTED_EVAL_LAUNCHES}")
    # device ms per eval step (torch.profiler): K5's 13 launches, and every
    # device interval of the step (one stream, so their sum is the busy time)
    split = launch_split_ms(lambda: fused_eval(state, raw, 0), ("r2p1d_pair", ""), iters=3)

    with torch.inference_mode():
        batch = preprocess_batch(raw, cfg.preprocess(), train=False)
    _lib.reset_launches()
    v, a = embed(batch["frames"], batch["audio"])
    torch.cuda.synchronize()
    embed_launches = dict(_lib.LAUNCHES)
    require(v.shape == a.shape == (b, 128), f"embedding shapes {v.shape}, {a.shape}")
    require(bool(torch.isfinite(v).all() and torch.isfinite(a).all()), "non-finite embeddings")
    require(embed_launches == EXPECTED_EMBED_LAUNCHES,
            f"kernel launches of the embed call {embed_launches}, "
            f"expected {EXPECTED_EMBED_LAUNCHES}")
    after = _snapshot(state)
    require(len(after) == len(before) and all(torch.equal(x, y) for x, y in zip(before, after)),
            "the eval path changed banks, Z, params or BN stats")
    return {
        "losses": losses.tolist(), "warmup_s": warmup_s, "step_ms": dt / TIMED_STEPS * 1e3,
        "clips_per_sec": b * TIMED_STEPS / dt, "peak_mem_gib": peak, "launches": launches,
        "embed_launches": embed_launches, "state_unchanged": True,
        "k5_device_ms_per_step": split["r2p1d_pair"], "device_busy_ms_per_step": split[""],
    }


def check_crop_color() -> dict:
    """One crop+color train preprocessing of the train slice's raw frames,
    the jitter in a random per-clip order, on the card (in f32, then in
    bf16, the card's dtype) and on the CPU (f32) from the same draws
    (drawn on the CPU)."""
    cfg = kinetics_cross_n1024()
    b, t = cfg.batch_size, cfg.num_frames
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.integers(0, 255, (b, t, *RAW_HW, 3), dtype=np.uint8))
    gen = torch.Generator().manual_seed(6)
    crop, resize = cfg.crop_size, (256, 256)
    top = torch.randint(0, resize[0] - crop + 1, (b,), generator=gen)
    left = torch.randint(0, resize[1] - crop + 1, (b,), generator=gen)
    u = torch.rand((b, 5), generator=gen)
    perm = torch.argsort(torch.rand((b, 4), generator=gen), dim=1)
    non_identity = int((perm != torch.arange(4)).any(dim=1).sum())
    require(non_identity >= b // 2, f"only {non_identity} non-identity jitter orders")
    args = (top, left, u[:, 0] < 0.5, u[:, 1:], perm)
    ref = video_aug.crop_augment_clips_train(frames, *args, crop, resize, dtype=torch.float32)
    frames_cuda, cuda_args = frames.cuda(), [a.cuda() for a in args]

    def on_card(dtype, canonical=False):
        # canonical: the same draws with the jitter in its fixed order (a
        # timing reference for the random order's cost)
        a = cuda_args[:-1] + [None] if canonical else cuda_args
        return video_aug.crop_augment_clips_train(frames_cuda, *a, crop, resize, dtype=dtype)

    f32_err = float((on_card(torch.float32).cpu() - ref).abs().max())
    diff = (on_card(torch.bfloat16).float().cpu() - ref).abs()
    line = {"name": "crop+color train preprocessing, random jitter order, card vs CPU (f32)",
            "shape": list(ref.shape), "f32_max_abs_err": f32_err,
            "bf16_max_abs_err": float(diff.max()), "bf16_mean_abs_err": float(diff.mean()),
            "tol": CROP_COLOR_TOL, "non_identity_orders": non_identity,
            "card_bf16_ms": time_ms(lambda: on_card(torch.bfloat16), 5),
            "card_bf16_canonical_order_ms": time_ms(lambda: on_card(torch.bfloat16, True), 5)}
    print(json.dumps(line), flush=True)
    require(ref.shape == (b, t, crop, crop, 3), f"crop+color shape {tuple(ref.shape)}")
    require(f32_err <= CROP_COLOR_TOL["f32_max_abs"],
            f"crop+color in f32: card and CPU disagree ({f32_err})")
    require(line["bf16_max_abs_err"] <= CROP_COLOR_TOL["bf16_max_abs"]
            and line["bf16_mean_abs_err"] <= CROP_COLOR_TOL["bf16_mean_abs"],
            f"crop+color in bf16: card and CPU disagree ({line['bf16_max_abs_err']}, "
            f"{line['bf16_mean_abs_err']})")
    return line


def run_cma_slice() -> dict:
    """The Kinetics AVID-CMA train slice at full width: the full mining
    sweep on the card, its sampled rows against the CPU, then 1 + 5 fused
    CMA train steps."""
    cfg = kinetics_cma()
    state, fused = build_pretrain(cfg, device="cuda")
    crit = cfg.criterion(state.model.out_dim)
    bank_v, bank_a = state.bank.view1_mem, state.bank.view2_mem
    n, d = bank_v.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pos = mining.mine_positives(bank_v, bank_a, crit.pos_k, crit.sampling_type)
    torch.cuda.synchronize()
    mine = {"mine_s": time.perf_counter() - t0,
            "mine_tile": mining.default_tile(n, bank_v.device),
            "mine_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            # the sweep's two (N, D) x (D, N) f32 products at the f32 peak
            "mine_flop_bound_s": 2 * 2.0 * n * n * d / F32_FLOPS}
    torch.cuda.empty_cache()
    check_positive_set(pos, n, crit.pos_k)
    rng = np.random.default_rng(8)
    rows = torch.from_numpy(rng.choice(n, MINING_SAMPLE_ROWS, replace=False))
    bv, ba = bank_v.cpu(), bank_a.cpu()
    cpu = mining.sweep(bv, ba, rows, crit.pos_k, crit.sampling_type)
    mine.update(mining_disagreement(pos[rows.cuda()], cpu, bv, ba, rows, crit.pos_k,
                                    crit.sampling_type))
    state.bank = avid_cma.cma_state_from_bank(state.bank, pos)
    del bank_v, bank_a, bv, ba  # the step replaces the banks: hold no old copy

    b, t = cfg.batch_size, cfg.num_frames
    raw = {
        "frames": torch.from_numpy(
            rng.integers(0, 255, (b, t, *RAW_HW, 3), dtype=np.uint8)).cuda(),
        "audio": torch.from_numpy(
            rng.standard_normal((b, int(cfg.audio_clip_duration * cfg.audio_fps)),
                                dtype=np.float32)).cuda(),
        "index": torch.from_numpy(rng.choice(n, b, replace=False)).cuda(),
    }
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS):
        fused(state, raw, i)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    z0 = float(state.bank.z)
    require(z0 > 0, f"Z not frozen after the first CMA step: {z0}")

    # record each step's negatives and the positives they were drawn past
    drawn = []
    draw = avid_cma.draw_negatives_avoid_sorted

    def recording_draw(pos_rows, *args, **kwargs):
        neg = draw(pos_rows, *args, **kwargs)
        drawn.append((pos_rows, neg))
        return neg

    avid_cma.draw_negatives_avoid_sorted = recording_draw
    try:
        _lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [fused(state, raw, WARMUP_STEPS + i)["loss"] for i in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
    finally:
        avid_cma.draw_negatives_avoid_sorted = draw
    peak = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"non-finite CMA loss {losses.tolist()}")
    require(float(state.bank.z) == z0, "Z changed after it was frozen")
    require(torch.equal(state.bank.positive_set, pos), "the step changed the positive set")
    for mem in (state.bank.view1_mem, state.bank.view2_mem):
        norms = torch.linalg.vector_norm(mem[raw["index"]], dim=1)
        require(float((norms - 1).abs().max()) < 1e-5, "touched bank rows not unit norm")
    require(len(drawn) == TIMED_STEPS, f"{len(drawn)} negative draws in {TIMED_STEPS} steps")
    for pos_rows, neg in drawn:
        require(torch.equal(pos_rows, pos[raw["index"]]), "negatives drawn past other rows")
        require(tuple(neg.shape) == (b, crit.num_negatives) and int(neg.min()) >= 0
                and int(neg.max()) < n, f"negatives {tuple(neg.shape)} out of range")
        require(not bool((neg[:, :, None] == pos_rows[:, None, :]).any()),
                "a drawn negative lies in its row's positive set")
    require(launches == EXPECTED_CMA_LAUNCHES,
            f"kernel launches on the CMA path {launches}, expected {EXPECTED_CMA_LAUNCHES}")
    # every device interval of a step (one stream, so their sum is the busy time)
    busy = launch_split_ms(lambda: fused(state, raw, 100), ("",), iters=3)[""]
    return {
        **mine, "losses": losses.tolist(), "z": z0, "warmup_s": warmup_s,
        "step_ms": dt / TIMED_STEPS * 1e3, "clips_per_sec": b * TIMED_STEPS / dt,
        "peak_mem_gib": peak, "launches": launches, "device_busy_ms_per_step": busy,
    }


def eval_launches(k2: int, k3: int, k5: int) -> dict:
    """Launch counts of the eval paths' kernels (K2, K3, K5; no K1, K4)."""
    return {"spectrogram": 0, "stem_pool_fwd": k2, "stem_pool_bwd": k3, "nce_gather": 0,
            "r2p1d_pair": k5, **NO_F32_STEM}


def per_step(kind: str, steps: int) -> dict:
    return eval_launches(*(steps * v for v in PER_STEP[kind]))


def _eval_model_cfg(model_dir: str) -> config_lib.Config:
    """The model section of the Cross-N1024 YAML, its run under
    ``model_dir`` (a directory without a run gives random weights)."""
    cfg = config_lib.load(LOOP_CONFIG).model
    cfg["model_dir"] = model_dir
    return cfg


def _eval_inputs(cfg: config_lib.Config, batch: int, seed: int):
    """``batch`` raw uint8 clips on the card at the config's decode_size,
    their labels, and the clip shape (T, crop, crop) the model takes."""
    db = cfg.dataset
    t = int(round(float(db["clip_duration"]) * float(db["video_fps"])))
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 255, (batch, t, *db["decode_size"], 3),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, int(cfg.model["args"]["n_classes"]),
                                           batch)).cuda()
    crop = int(db["crop_size"])
    return frames, labels, (t, crop, crop)


def _finetune_model(cfg: config_lib.Config, clip_shape, model_dir: str):
    """The YAML's ClassificationWrapper over a random R2Plus1D-18 (the
    entry point's backbone loader, pointed at no run) on the card."""
    backbone, source = eval_loop.load_backbone(_eval_model_cfg(model_dir), torch.device("cuda"))
    require(source is None, f"a backbone was found at {source}")
    margs = cfg.model["args"]
    return ClassificationWrapper(
        backbone, int(margs["n_classes"]), clip_shape, feat_name=margs["feat_name"],
        pooling_op=margs["pooling_op"], use_dropout=bool(margs["use_dropout"]),
        dropout=float(margs["dropout"])).cuda()


def timed_eval_steps(state: TrainState, fused, frames, labels, kind: str,
                     steps: int = TIMED_STEPS, busy: bool = True) -> dict:
    """One untimed fused step, then ``steps`` timed ones with the launch
    counters reset just before them: finite losses, PER_STEP[kind]
    launches a step; clips/s on the host clock (the card synchronized),
    the peak memory, and the device-busy ms a step (torch.profiler, 3
    more steps)."""
    t0 = time.perf_counter()
    fused(state, frames, labels)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    _lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [fused(state, frames, labels)[0]["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"{kind}: non-finite loss {losses.tolist()}")
    want = per_step(kind, steps)
    require(launches == want, f"{kind} steps launched {launches}, expected {want}")
    out = {"losses": losses.tolist(), "warmup_s": warmup_s, "step_ms": dt / steps * 1e3,
           "clips_per_sec": frames.shape[0] * steps / dt, "peak_mem_gib": peak,
           "launches": launches,
           "launches_per_step": dict(zip(("K2", "K3", "K5"), PER_STEP[kind]))}
    if busy:
        out["device_busy_ms_per_step"] = launch_split_ms(
            lambda: fused(state, frames, labels), ("",), iters=3)[""]
    return out


@contextlib.contextmanager
def plain_stem_backward():
    """K3's wrapper replaced by its plain version inside the block: the
    stem's backward on the same card tensors, with no launch."""
    kernel = stem_pool.stem_pool_bwd
    stem_pool.stem_pool_bwd = stem_pool.plain_bwd
    try:
        yield
    finally:
        stem_pool.stem_pool_bwd = kernel


def check_small_evals() -> dict:
    """A warmup step, a finetune step and a probe step at a small size
    (R2Plus1D-10, 8 clips of 8 x 64^2, 5 classes) on the card and on the
    CPU from the same weights and BN running stats (drawn from a seed) and
    the same frames: each loss within 2% of the CPU's (each tap's for the
    probe). The first finetune step's backbone gradient, and the update:
    - on each device, every backbone parameter takes Adam's first step
      from its own gradient (the finetune optimizer holds the whole
      backbone, and the warmup's freeze is undone);
    - on the card, the stem's gradients (what K3's dy, da and db feed)
      equal, within 1e-3 in relative L2 norm, those of the same forward
      backpropagated through K3's plain version on the same tensors;
    - the card's backbone gradient points the CPU's f32 way, within what
      bf16 arithmetic allows (GRAD_COS_BF16) and 5% of its norm.
    On the card the warmup leaves the backbone's parameters the same bits
    and moves its BN running stats, the probe leaves the extractor
    (parameters and stats) the same bits, and each step launches what
    PER_STEP says (K5 on R2Plus1D-10's five pairs)."""
    rng = np.random.default_rng(8)
    clip, ncls, b = (8, 64, 64), 5, 8
    frames = rng.standard_normal((b, *clip, 3), dtype=np.float32)
    labels = rng.integers(0, ncls, b)
    weights = R2Plus1D(10)
    init_params(weights, torch.Generator().manual_seed(0))
    stats = np.random.default_rng(9)
    for m in weights.modules():
        if isinstance(m, BatchNorm):
            c = m.running_mean.numel()
            m.running_mean.copy_(torch.from_numpy(stats.normal(0, 0.1, c).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(stats.uniform(0.5, 1.5, c).astype(np.float32)))
    taps = ["conv2x", "conv3x", "conv4x", "conv5x"]
    pools = ["AdaptiveMaxPool3d((1, 6, 6))", "AdaptiveMaxPool3d((1, 4, 4))",
             "AdaptiveMaxPool3d((1, 3, 3))", "AdaptiveMaxPool3d((1, 2, 2))"]

    def backbone(dev):
        net = R2Plus1D(10, dtype=torch.bfloat16 if dev == "cuda" else torch.float32)
        net.load_state_dict(weights.state_dict())
        return net

    lr = 1e-3

    def state(model, params, dev):
        opt = build_optimizer(params, "adam", lr)
        return TrainState(model, opt, multistep_scheduler(opt, [], 1.0), None,
                          torch.Generator(device=dev))

    def counted(dev, per, fn):
        """fn() launching the (K2, K3, K5) counts ``per`` on the card, none
        on the CPU."""
        _lib.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        want = eval_launches(*(v if dev == "cuda" else 0 for v in per))
        require(dict(_lib.LAUNCHES) == want,
                f"small step on {dev} launched {dict(_lib.LAUNCHES)}, expected {want}")
        return out

    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        x = torch.from_numpy(frames).to(dev)
        y = torch.from_numpy(labels).to(dev)
        step = eval_loop.make_supervised_train_step()
        model = ClassificationWrapper(backbone(dev), ncls, clip).to(dev)
        params0 = [p.detach().clone() for p in model.feature_extractor.parameters()]
        stats0 = [t.clone() for t in model.feature_extractor.buffers()]
        st = state(model, classifier_parameters(model), dev)
        with eval_loop.frozen(model.feature_extractor):
            warm = counted(dev, PER_STEP["warmup"], lambda: step(st, x, y))[0]["loss"]
        require(all(torch.equal(p, q) for p, q in
                    zip(model.feature_extractor.parameters(), params0)),
                f"the warmup step on {dev} changed the backbone's parameters")
        require(not all(torch.equal(p, q) for p, q in
                        zip(model.feature_extractor.buffers(), stats0)),
                f"the warmup step on {dev} left every BN running stat as it was")
        st = state(model, model.parameters(), dev)
        twin = copy.deepcopy(model)  # for the card's plain-K3 gradient
        before = [p.detach().clone() for p in model.feature_extractor.parameters()]
        fine = counted(dev, PER_STEP["finetune"], lambda: step(st, x, y))[0]["loss"]
        trained = list(model.feature_extractor.parameters())
        grads[dev] = torch.cat([p.grad.detach().flatten() for p in trained]).cpu().double()
        update_err = max(float((p.detach() - p0 + lr * p.grad / (p.grad.abs() + 1e-8)
                                ).abs().max()) for p, p0 in zip(trained, before))
        require(update_err <= 1e-3 * lr,
                f"the finetune step on {dev} did not take Adam's step on every backbone "
                f"parameter (off by {update_err})")
        if dev == "cuda":
            with plain_stem_backward():
                twin.train()
                F.cross_entropy(twin(x), y.long()).backward()
            k3_rel = {name: float((p.grad - q.grad).norm() / q.grad.norm()) for (name, p), q in
                      zip(model.feature_extractor.conv1.named_parameters(),
                          twin.feature_extractor.conv1.parameters())}
            require(max(k3_rel.values()) <= 1e-3,
                    f"the stem's gradients through K3 and through its plain version differ "
                    f"({k3_rel})")
        del twin, before

        probe = MOSTModel(backbone(dev), ncls, taps, pools, clip, use_bn=True).to(dev)
        extractor = [t.clone() for t in probe.feature_extractor.state_dict().values()]
        pst = state(probe, classifier_parameters(probe), dev)
        # R2Plus1D-10 has five stride-1 pairs (R2Plus1D-18: 13)
        pm = counted(dev, (1, 0, 5), lambda: eval_loop.make_supervised_train_step(True)(
            pst, x, y))[0]
        require(all(torch.equal(p, q) for p, q in
                    zip(probe.feature_extractor.state_dict().values(), extractor)),
                f"the probe step on {dev} changed the extractor")
        out[dev] = {"warmup": float(warm), "finetune": float(fine),
                    **{ft: float(pm[ft]) for ft in taps}}
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in out["cpu"]}
    got, ref = grads["cuda"], grads["cpu"]
    cos = float(got @ ref / (got.norm() * ref.norm()))
    norm_rel = abs(float(got.norm() / ref.norm()) - 1.0)
    line = {"name": "small eval steps, card vs CPU", "loss_cuda": out["cuda"],
            "loss_cpu": out["cpu"], "loss_rel": rel, "backbone_grad_cos": cos,
            "backbone_grad_norm_rel": norm_rel, "stem_grad_k3_vs_plain_rel": k3_rel,
            "adam_update_err": update_err,
            "tol": {"loss_rel": 2e-2, "backbone_grad_cos": GRAD_COS_BF16,
                    "backbone_grad_norm_rel": 5e-2, "stem_grad_k3_vs_plain_rel": 1e-3,
                    "adam_update_err": 1e-3 * lr},
            "warmup_backbone_params_unchanged": True, "probe_extractor_unchanged": True}
    print(json.dumps(line), flush=True)
    require(max(rel.values()) <= 2e-2, f"small eval steps: card and CPU disagree ({rel})")
    require(cos >= GRAD_COS_BF16 and norm_rel <= 5e-2,
            f"small finetune step: the backbone's gradients disagree (cos {cos}, norm {norm_rel})")
    return line


def run_finetune_slice(model_dir: str) -> dict:
    """configs/benchmark/ucf/8at16-fold1.yaml at its batch (64): R2Plus1D-18
    with a 101-class head, dropout 0.5, raw 8 x 256 x 342 frames through
    msc+color on the card; 1 + 5 classifier-only warmup steps (the
    backbone frozen: its parameters the same bits after them), 1 + 5
    finetune steps with a fresh optimizer, then a clip-test forward."""
    cfg = config_lib.load(UCF_8AT16)
    frames, labels, clip = _eval_inputs(cfg, int(cfg.dataset["batch_size"]), 20)
    pp = builders.build_preprocess_config(cfg.dataset)
    model = _finetune_model(cfg, clip, model_dir)
    backbone = model.feature_extractor
    state = TrainState(model, *build_from_config(cfg.optimizer, classifier_parameters(model)),
                       None, torch.Generator(device="cuda"))
    fused = eval_loop.make_fused_supervised_step(pp, eval_loop.FINETUNE_SEED)
    params0 = [p.detach().clone() for p in backbone.parameters()]
    with eval_loop.frozen(backbone):
        warm = timed_eval_steps(state, fused, frames, labels, "warmup")
    require(all(torch.equal(p, q) for p, q in zip(backbone.parameters(), params0)),
            "the warmup steps changed the backbone's parameters")
    del params0
    state.optimizer, state.scheduler = build_from_config(cfg.optimizer, model.parameters())
    fine = timed_eval_steps(state, fused, frames, labels, "finetune")

    logits_fn = eval_loop.make_logits_fn(model)
    with torch.inference_mode():
        x = preprocess_batch({"frames": frames}, pp, train=False)["frames"]
    logits_fn(x)
    torch.cuda.synchronize()
    _lib.reset_launches()
    logits = logits_fn(x)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    require(launches == per_step("test", 1), f"clip-test forward launched {launches}")
    require(logits.shape == (frames.shape[0], 101) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()), f"test logits {logits.shape} {logits.dtype}")
    ms = time_ms(lambda: logits_fn(x), 5)
    split = launch_split_ms(lambda: logits_fn(x), ("r2p1d_pair", ""), iters=3)
    return {"warmup": warm, "finetune": fine, "test_forward": {
        "ms": ms, "clips_per_sec": frames.shape[0] / ms * 1e3, "launches": launches,
        "k5_device_ms": split["r2p1d_pair"], "device_busy_ms": split[""]},
        "warmup_backbone_params_unchanged": True}


def run_32at16_slice(model_dir: str) -> dict:
    """configs/benchmark/ucf/32at16-fold1.yaml: 1 + STEPS_32AT16 finetune
    steps at BATCH_32AT16 clips of 32 frames (the stem's K2/K3 tensors are
    64 x 32 x 112^2 x 64)."""
    cfg = config_lib.load(UCF_32AT16)
    frames, labels, clip = _eval_inputs(cfg, BATCH_32AT16, 22)
    pp = builders.build_preprocess_config(cfg.dataset)
    model = _finetune_model(cfg, clip, model_dir)
    state = TrainState(model, *build_from_config(cfg.optimizer, model.parameters()), None,
                       torch.Generator(device="cuda"))
    fused = eval_loop.make_fused_supervised_step(pp, eval_loop.FINETUNE_SEED)
    return {"batch": BATCH_32AT16, "frames": clip[0],
            **timed_eval_steps(state, fused, frames, labels, "finetune", steps=STEPS_32AT16,
                               busy=False)}


def run_probe_slice(model_dir: str) -> dict:
    """configs/benchmark/kinetics/8x224x224-linear.yaml at its batch (128):
    raw 8 x 256 x 342 frames through crop+color, the frozen R2Plus1D-18
    extractor in eval mode (K5), four taps pooled to (1,12,12), (1,8,8),
    (1,6,6), (1,4,4), BN + Linear to 400 each, the per-tap losses summed:
    1 + 5 steps; no K3 and 13 K5 launches a step, the extractor
    (parameters and BN stats) the same bits after them."""
    cfg = config_lib.load(KINETICS_LINEAR)
    margs = cfg.model["args"]
    frames, labels, clip = _eval_inputs(cfg, int(cfg.dataset["batch_size"]), 23)
    pp = builders.build_preprocess_config(cfg.dataset)
    backbone, source = eval_loop.load_backbone(_eval_model_cfg(model_dir), torch.device("cuda"))
    require(source is None, f"a backbone was found at {source}")
    model = MOSTModel(backbone, int(margs["n_classes"]), list(margs["feat_names"]),
                      list(margs["pooling_ops"]), clip, l2_norm=margs.get("l2_norm"),
                      use_bn=bool(margs["use_bn"])).cuda()
    state = TrainState(model, *build_from_config(cfg.optimizer, classifier_parameters(model)),
                       None, torch.Generator(device="cuda"))
    fused = eval_loop.make_fused_supervised_step(pp, eval_loop.PROBE_SEED, multi_output=True)
    extractor = [t.clone() for t in model.feature_extractor.state_dict().values()]
    out = timed_eval_steps(state, fused, frames, labels, "probe")
    require(all(torch.equal(p, q) for p, q in
                zip(model.feature_extractor.state_dict().values(), extractor)),
            "the probe steps changed the extractor's parameters or BN stats")
    metrics, _ = fused(state, frames, labels)
    taps = {ft: float(metrics[ft]) for ft in margs["feat_names"]}
    require(all(np.isfinite(v) for v in taps.values()), f"probe tap losses {taps}")
    return {**out, "tap_losses": taps, "features": [
        getattr(model, f"classifier_{ft}").classifier.in_features for ft in margs["feat_names"]],
        "extractor_unchanged": True}


def _eval_loop_launches() -> dict:
    """The eval loops' launches: the finetune run and its test_only rerun,
    the probe run and its test_only rerun (PER_STEP a step or forward)."""
    def batches(clips, batch):
        return -(-clips // batch)
    ft_train = FT_VIDEOS * FT_TRAIN_CLIPS // FT_BATCH  # steps an epoch (drop_last)
    ft_test = batches(FT_VIDEOS * 5, FT_BATCH)  # the YAML's 5 clips a test video
    ft_final = batches(FT_VIDEOS * 25, FT_BATCH) + batches(FT_VIDEOS * 10, FT_BATCH)  # + dense
    pr_train = PROBE_VIDEOS // PROBE_BATCH
    pr_final = batches(PROBE_VIDEOS, PROBE_BATCH) + batches(PROBE_VIDEOS * 10, PROBE_BATCH)
    # + each run's one-clip forward that sizes its heads (tap_shapes)
    counts = {"warmup": ft_train, "finetune": ft_train, "probe": pr_train,
              "test": 2 * ft_test + 2 * ft_final + 2 * pr_final + 4}
    total = [sum(n * PER_STEP[k][i] for k, n in counts.items()) for i in range(3)]
    return eval_launches(*total)


def run_eval_loops(model_dir: str) -> dict:
    """The eval entry points, chained from the loop phase's AVID run in
    ``model_dir``: ``run_action_recognition`` on the 8at16 YAML (synthetic
    corpus, one warmup and one finetune epoch, the 25-clip final test, the
    dense eval), then again with ``test_only=true`` (the same results);
    ``run_linear_probe`` on the Kinetics linear YAML likewise. Both load
    the AVID run's video model: the warmup's checkpoint holds its
    parameters, and the probe's its parameters and BN stats, bit for bit.
    The launches of each kernel over the four runs."""
    mcfg = _eval_model_cfg(model_dir)
    run_dir = os.path.join(model_dir, mcfg["name"])
    pretrained = {k.split(".", 1)[1]: v for k, v in import_model_run(run_dir).items()
                  if k.startswith("video_model.")}
    runs = (("finetune", eval_loop.run_action_recognition, UCF_8AT16, FT_LOOP_OVERRIDES),
            ("probe", eval_loop.run_linear_probe, KINETICS_LINEAR, PROBE_LOOP_OVERRIDES))
    out = {}
    with loop_log(os.path.join(model_dir, "eval_stdout.log"), "eval loops"):
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        for name, run, path, overrides in runs:
            for extra in ([], ["test_only=true"]):
                t0 = time.perf_counter()
                res = run(config_lib.load(path, overrides + extra), mcfg, fold=1, device="cuda")
                torch.cuda.synchronize()
                out[name + ("_test_only" if extra else "")] = {
                    "results": res, "s": time.perf_counter() - t0}
        launches = dict(_lib.LAUNCHES)
    for name in ("finetune", "probe"):
        require(out[name + "_test_only"]["results"] == out[name]["results"],
                f"{name}: test_only gave {out[name + '_test_only']['results']}, "
                f"the run {out[name]['results']}")
    flat = [v for k in ("finetune", "probe") for v in (
        out[k]["results"].values() if k == "finetune"
        else [x for tap in out[k]["results"].values() for x in tap.values()])]
    require(all(0.0 <= v <= 100.0 for v in flat), f"accuracies {flat}")
    want = _eval_loop_launches()
    require(launches == want, f"kernel launches of the eval loops {launches}, expected {want}")

    def eval_dir(path):
        return os.path.join(run_dir, f"eval-{config_lib.load(path).benchmark['name']}", "fold-01")

    def latest(directory):
        mgr = CheckpointManager(directory)
        return torch.load(mgr.path(mgr.latest_step()), map_location="cpu",
                          weights_only=False)["model"]

    warm = latest(os.path.join(eval_dir(UCF_8AT16), "checkpoints_warmup"))
    probe = latest(os.path.join(eval_dir(KINETICS_LINEAR), "checkpoints"))
    require(all(torch.equal(warm["feature_extractor." + k], v) for k, v in pretrained.items()
                if "running_" not in k),
            "the finetune's backbone after the warmup is not the AVID run's video model")
    require(all(torch.equal(probe["feature_extractor." + k], v) for k, v in pretrained.items()),
            "the probe's extractor is not the AVID run's video model")
    return {**out, "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "backbone_from_avid_run": "bit-exact"}


def trace_device_share(path: str) -> dict:
    """Device busy time and the device's idle share over a
    ``torch.profiler`` chrome trace: the union of the kernel, memcpy and
    memset intervals against the span of every interval in the trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    require(bool(events), f"empty trace {path}")
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    require(bool(dev), f"no device activity in the trace {path}")
    busy, end = 0.0, -1.0
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(float(e["ts"]) + float(e["dur"]) for e in events) - min(
        float(e["ts"]) for e in events)
    return {"trace_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / span, "kernels": sum(
                1 for e in events if e.get("cat") == "kernel")}


def _loop_config(model_dir: str, extra=(), path: str = LOOP_CONFIG) -> config_lib.Config:
    return config_lib.load(path, LOOP_OVERRIDES + [f"model.model_dir={model_dir}", *extra])


@contextlib.contextmanager
def loop_log(path: str, title: str):
    """The loop's log (config, parameter table, progress) goes to a file
    while the block runs, so that this script's output stays one line a
    check; its tail is printed to stderr after it, whatever happened."""
    try:
        with open(path, "w") as log, contextlib.redirect_stdout(log):
            yield
    finally:
        if os.path.exists(path):
            with open(path) as f:
                tail = [ln for ln in f.read().splitlines() if "|" not in ln][-30:]
            print("\n".join([f"== {title} log (tail, no parameter table)"] + tail),
                  file=sys.stderr)


def run_loop(model_dir: str) -> dict:
    """The pretraining entry point from the YAML: one epoch, then a resume
    for a second; the checkpoint, the .pth.tar round trip and the
    launches of each kernel over both runs. The run's directory stays in
    ``model_dir`` for the AVID-CMA loop phase."""
    records = []
    with loop_log(os.path.join(model_dir, "stdout.log"), "run_pretraining"):
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        first = run_pretraining(_loop_config(model_dir), device="cuda",
                                on_epoch=records.append)
        require((first.step, first.epoch) == (LOOP_STEPS, 1),
                f"first run ended at step {first.step}, epoch {first.epoch}")
        del first
        # the second run traces its epoch's steps (the loop's
        # profile_steps window) for the device's idle share
        second = run_pretraining(
            _loop_config(model_dir, ["resume=true", "optimizer.num_epochs=2",
                                     f"profile_steps=[{LOOP_STEPS},{2 * LOOP_STEPS}]"]),
            device="cuda", on_epoch=records.append)
        torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    require([(r["epoch"], r["start_step"], r["steps"]) for r in records]
            == [(0, 0, LOOP_STEPS), (1, LOOP_STEPS, LOOP_STEPS)],
            f"epochs run {[(r['epoch'], r['start_step'], r['steps']) for r in records]}")
    require(second.step == 2 * LOOP_STEPS and second.epoch == 2,
            f"second run ended at step {second.step}, epoch {second.epoch}")
    losses = [v for r in records for v in (r["loss"], r["test_loss"])]
    require(all(v is not None and np.isfinite(v) for v in losses), f"losses {losses}")
    require(launches == EXPECTED_LOOP_LAUNCHES,
            f"kernel launches of the loop {launches}, expected {EXPECTED_LOOP_LAUNCHES}")

    trace = os.path.join(model_dir, "Cross-N1024", "profile",
                         f"trace_steps_{LOOP_STEPS}_{2 * LOOP_STEPS}.json")
    require(os.path.isfile(trace), "the loop wrote no profiler trace")
    share = trace_device_share(trace)
    ckdir = os.path.join(model_dir, "Cross-N1024", "checkpoints")
    mgr = CheckpointManager(ckdir)
    require(mgr.latest_step() == 2 * LOOP_STEPS, f"latest checkpoint {mgr.latest_step()}")
    saved = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=False)
    for key in ("view1_mem", "view2_mem"):
        mem = getattr(second.bank, key)
        bank = saved["bank"][key]
        require(torch.equal(bank, mem.cpu()), f"checkpoint {key} differs from the state")
        norms = torch.linalg.vector_norm(bank, dim=1)
        require(float((norms - 1).abs().max()) < 1e-5, f"checkpoint {key} rows not unit norm")
    require(float(saved["bank"]["z"]) > 0, "checkpoint Z not frozen")

    # .pth.tar export of the final state, then each import: the same bits
    path = os.path.join(model_dir, "export.pth.tar")
    export_pth_tar(path, second.model, bank=second.bank, epoch=second.epoch,
                   optimizer=second.optimizer)
    model_sd = import_model_pth_tar(path)
    own = second.model.state_dict()
    require(sorted(model_sd) == sorted(own) and all(
        torch.equal(model_sd[k], own[k].cpu()) for k in own), "model round trip differs")
    bank = import_criterion_pth_tar(path, "cuda")
    require(torch.equal(bank.view1_mem, second.bank.view1_mem)
            and torch.equal(bank.view2_mem, second.bank.view2_mem)
            and torch.equal(bank.z, second.bank.z), "bank round trip differs")
    fresh = torch.optim.Adam(second.model.parameters(), lr=1.0)
    import_optimizer_pth_tar(path, second.model, fresh)
    for p in second.model.parameters():
        a, b = fresh.state[p], second.optimizer.state[p]
        require(all(torch.equal(a[k].to(b[k].device), b[k])
                    for k in ("step", "exp_avg", "exp_avg_sq")), "Adam round trip differs")
    return {
        "clips_per_sec_per_epoch": [r["clips"] / r["train_s"] for r in records],
        "loader_wait_share_per_epoch": [r["loader_wait_s"] / r["train_s"] for r in records],
        "train_s_per_epoch": [r["train_s"] for r in records],
        "train_loss_per_epoch": [r["loss"] for r in records],
        "test_loss_per_epoch": [r["test_loss"] for r in records],
        "resumed_at": {"epoch": records[1]["epoch"], "step": records[1]["start_step"]},
        "final_step": second.step, "peak_mem_gib": peak, "launches": launches,
        "traced_steps": [LOOP_STEPS, 2 * LOOP_STEPS], **share,
        "pth_tar_round_trip": "bit-exact",
    }


def run_cma_loop(model_dir: str) -> dict:
    """The pretraining entry point on the Kinetics AVID-CMA YAML, warm-
    started from the AVID loop phase's run directory in ``model_dir``
    (model, banks and Z), re-mining every epoch: one epoch, then a resume
    for a second; Z, the mining at each epoch's start, the last
    checkpoint's positive set and each kernel's launches over both runs."""
    avid_run = os.path.join(model_dir, "Cross-N1024")
    avid_z = import_criterion_run(avid_run).z
    chain = [f"model.args.checkpoint={avid_run}", f"loss.args.checkpoint={avid_run}",
             "loss.args.resample_freq=1"]
    records = []
    with loop_log(os.path.join(model_dir, "cma_stdout.log"), "run_pretraining (AVID-CMA)"):
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        first = run_pretraining(_loop_config(model_dir, chain, CMA_LOOP_CONFIG),
                                device="cuda", on_epoch=records.append)
        require((first.step, first.epoch) == (LOOP_STEPS, 1),
                f"first CMA run ended at step {first.step}, epoch {first.epoch}")
        first_z = first.bank.z.cpu()
        del first
        second = run_pretraining(
            _loop_config(model_dir, chain + ["resume=true", "optimizer.num_epochs=2"],
                         CMA_LOOP_CONFIG), device="cuda", on_epoch=records.append)
        torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    require([(r["epoch"], r["start_step"], r["steps"]) for r in records]
            == [(0, 0, LOOP_STEPS), (1, LOOP_STEPS, LOOP_STEPS)],
            f"CMA epochs run {[(r['epoch'], r['start_step'], r['steps']) for r in records]}")
    require(second.step == 2 * LOOP_STEPS and second.epoch == 2,
            f"second CMA run ended at step {second.step}, epoch {second.epoch}")
    require([r["mine_s"] is not None for r in records] == [True, True],
            f"mining before each epoch {[r['mine_s'] for r in records]}: the first run must "
            "mine, the resumed one re-mine at epoch 1")
    losses = [v for r in records for v in (r["loss"], r["test_loss"])]
    require(all(v is not None and np.isfinite(v) for v in losses), f"CMA losses {losses}")
    require(float(avid_z) > 0 and torch.equal(first_z, avid_z)
            and torch.equal(second.bank.z.cpu(), avid_z),
            f"Z {float(second.bank.z)} is not the AVID run's {float(avid_z)}")
    require(launches == EXPECTED_CMA_LOOP_LAUNCHES,
            f"kernel launches of the CMA loop {launches}, expected {EXPECTED_CMA_LOOP_LAUNCHES}")
    mgr = CheckpointManager(os.path.join(model_dir, "InstX-N1024-PosW-N64-Top32", "checkpoints"))
    require(mgr.latest_step() == 2 * LOOP_STEPS, f"latest CMA checkpoint {mgr.latest_step()}")
    saved = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=False)
    pos = saved["bank"]["positive_set"]
    n = second.bank.view1_mem.shape[0]
    check_positive_set(pos, n, second.bank.positive_set.shape[1])
    require(torch.equal(pos, second.bank.positive_set.cpu()),
            "checkpoint positive set differs from the state")
    return {
        "clips_per_sec_per_epoch": [r["clips"] / r["train_s"] for r in records],
        "loader_wait_share_per_epoch": [r["loader_wait_s"] / r["train_s"] for r in records],
        "mine_s_per_epoch": [r["mine_s"] for r in records],
        "train_s_per_epoch": [r["train_s"] for r in records],
        "train_loss_per_epoch": [r["loss"] for r in records],
        "test_loss_per_epoch": [r["test_loss"] for r in records],
        "z_from_avid_run": float(avid_z), "bank_rows": n,
        "final_step": second.step, "peak_mem_gib": peak, "launches": launches,
    }


@contextlib.contextmanager
def one_rank_world():
    """torchrun's environment for a world of one process on this card (a
    free localhost port) while the block runs; the process group, if the
    block left one up, is destroyed after it and the environment
    restored."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        mesh.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_sharded_primitives(smi: str) -> dict:
    """The row-sharded bank primitives at AudioSet size in a one-rank NCCL
    world: scores_sharded (K4 on the shard, forward and dq) against direct
    gather_scores, and the sharded bank EMA against the replicated one,
    both the same bits; each timed with CUDA events beside its replicated
    form (at one rank the collectives are copies on the card)."""
    n, d, b, k, t = AUDIOSET_ROWS, 128, 32, 1024, 0.07
    gen = torch.Generator(device="cuda").manual_seed(11)
    bank = l2_normalize(torch.randn((n, d), generator=gen, device="cuda"))
    idx = torch.randint(0, n, (b, k), generator=gen, device="cuda")
    q = l2_normalize(torch.randn((b, d), generator=gen, device="cuda"))
    g = torch.randn((b, k), generator=gen, device="cuda")
    y = torch.randint(0, n, (b,), generator=gen, device="cuda")
    y[-1] = y[0]  # a duplicate id: last-write-wins
    emb = l2_normalize(torch.randn((b, d), generator=gen, device="cuda"))
    with one_rank_world():
        world = mesh.initialize("cuda")
        layout = sharding.BankLayout(n=n, world=world, sharded=True)
        shard = sharding.shard_rows(bank, 0, 1)
        qs, qr = q.clone().requires_grad_(True), q.clone().requires_grad_(True)
        _lib.reset_launches()
        got = sharding.scores_sharded(shard, idx, qs, layout, t)
        launches = _lib.LAUNCHES["nce_gather"]
        want = nce_gather.gather_scores(bank, idx, qr, t)
        got.backward(g)
        want.backward(g)
        require(launches == 1, f"scores_sharded launched K4 {launches} times, not once")
        require(torch.equal(got, want), "scores_sharded differs from gather_scores")
        require(torch.equal(qs.grad, qr.grad), "scores_sharded's dq differs from gather_scores'")
        last = _last_occurrence(y)
        new_shard = sharding.ema_update_rows_sharded(shard, y, emb, 0.5, layout, last)
        replicated = bank.clone().index_put_(
            (y,), l2_normalize(bank[y] * 0.5 + emb * 0.5)[last])
        require(torch.equal(new_shard[:n], replicated) and not new_shard[n].any(),
                "the sharded bank EMA differs from the replicated one")
        del new_shard, replicated
        ms = {
            "scores_sharded_ms": time_ms(
                lambda: sharding.scores_sharded(shard, idx, q, layout, t), 20),
            "scores_replicated_ms": time_ms(
                lambda: nce_gather.gather_scores(bank, idx, q, t), 20),
            "ema_sharded_ms": time_ms(
                lambda: sharding.ema_update_rows_sharded(shard, y, emb, 0.5, layout, last), 10),
            "ema_replicated_ms": time_ms(lambda: bank.clone().index_put_(
                (y,), l2_normalize(bank[y] * 0.5 + emb * 0.5)[last]), 10),
        }
    out = {"name": "sharded bank primitives, one-rank NCCL world", "card": smi,
           "rows": n, "batch": b, "negatives": k, "scores_equal": True, "dq_equal": True,
           "ema_equal": True, "k4_launches_per_call": launches,
           "times_are": "CUDA events, mean over calls; the EMA's include the bank copy",
           **ms}
    print(json.dumps(out), flush=True)
    return out


def _final(state: TrainState) -> dict:
    """The state's full banks (the shard's N rows), Z and state_dict, on
    the host."""
    bank = state.bank
    n = state.layout.n
    return {"view1_mem": bank.view1_mem[:n].cpu(), "view2_mem": bank.view2_mem[:n].cpu(),
            "z": bank.z.cpu(), "model": {k: v.cpu() for k, v in state.model.state_dict().items()}}


def run_audioset_loop(model_dir: str) -> dict:
    """The AudioSet AVID YAML from the entry point with its sharded banks
    in a one-rank NCCL world (--multihost), one epoch and a resume; then
    the same with replicated banks and no process group; both the same
    bits, under cuDNN's deterministic algorithms (nondeterministic
    convolution backward algorithms would make two runs of one layout
    differ already)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for layout in ("sharded", "replicated"):
            run_dir = os.path.join(model_dir, f"audioset-{layout}")
            args = [AUDIOSET_CONFIG] + [a for o in AUDIOSET_OVERRIDES + [
                f"model.model_dir={run_dir}", f"loss.bank_sharding={layout}"]
                for a in ("--set", o)]
            world = one_rank_world if layout == "sharded" else contextlib.nullcontext
            flag = ["--multihost"] if layout == "sharded" else []
            records = []
            with loop_log(os.path.join(model_dir, f"audioset_{layout}.log"),
                          f"run_pretraining AudioSet ({layout})"):
                torch.cuda.reset_peak_memory_stats()
                _lib.reset_launches()
                with world():
                    first = pretrain_main(args + flag, on_epoch=records.append)
                require(first.bank.view1_mem.shape[0] == AUDIOSET_ROWS + (layout == "sharded"),
                        f"{layout} banks of {first.bank.view1_mem.shape[0]} rows")
                del first
                with world():
                    second = pretrain_main(args + flag + ["--set", "resume=true", "--set",
                                                          "optimizer.num_epochs=2"],
                                           on_epoch=records.append)
                torch.cuda.synchronize()
            launches = dict(_lib.LAUNCHES)
            require([(r["epoch"], r["start_step"], r["steps"]) for r in records]
                    == [(0, 0, LOOP_STEPS), (1, LOOP_STEPS, LOOP_STEPS)],
                    f"AudioSet {layout} epochs "
                    f"{[(r['epoch'], r['start_step'], r['steps']) for r in records]}")
            require(launches == EXPECTED_AUDIOSET_LAUNCHES,
                    f"AudioSet {layout} launches {launches}, expected {EXPECTED_AUDIOSET_LAUNCHES}")
            runs[layout] = {"records": records, "launches": launches,
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                            "final": _final(second), "run_dir": run_dir}
            del second
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sh, rep = runs["sharded"], runs["replicated"]
    losses = [[v for r in run["records"] for v in r["step_losses"]] for run in (sh, rep)]
    require(len(losses[0]) == 2 * LOOP_STEPS and all(np.isfinite(losses[0])),
            f"AudioSet losses {losses[0]}")
    require(losses[0] == losses[1], f"per-step losses differ: sharded {losses[0]}, "
            f"replicated {losses[1]}")
    a, b = sh["final"], rep["final"]
    for key in ("view1_mem", "view2_mem", "z"):
        require(torch.equal(a[key], b[key]), f"sharded and replicated {key} differ")
    differ = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    require(not differ, f"sharded and replicated parameters differ: {differ[:5]}")
    require(float(a["z"]) > 0, "Z not frozen")
    mgr = CheckpointManager(os.path.join(sh["run_dir"], "Cross-N1024", "checkpoints"))
    saved = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=False)
    rows = [tuple(saved["bank"][k].shape) for k in ("view1_mem", "view2_mem")]
    require(rows == [(AUDIOSET_ROWS, 128)] * 2, f"checkpoint banks {rows}")
    require(torch.equal(saved["bank"]["view1_mem"], a["view1_mem"]),
            "checkpoint banks differ from the state's")
    return {
        "bank_rows": AUDIOSET_ROWS, "checkpoint_bank_rows": rows[0][0],
        "step_losses": losses[0], "bit_equal_to_replicated": True,
        "clips_per_sec_per_epoch": {k: [r["clips"] / r["train_s"] for r in run["records"]]
                                    for k, run in runs.items()},
        "loader_wait_share_per_epoch": {
            k: [r["loader_wait_s"] / r["train_s"] for r in run["records"]]
            for k, run in runs.items()},
        "peak_mem_gib": {k: run["peak_mem_gib"] for k, run in runs.items()},
        "launches": {k: sh["launches"][k] + rep["launches"][k] for k in sh["launches"]},
    }


def run_cma_sharded(model_dir: str) -> dict:
    """The Kinetics AVID-CMA YAML with row-sharded banks in a one-rank
    NCCL world, chained from the loop phase's AVID run: one epoch; the
    positive set its row-sharded sweep mined against mine_positives of
    the AVID run's banks; then the row-sharded sweep against
    mine_positives at N = 232,067 random unit rows (the CMA slice's size),
    both equal except at near-ties."""
    avid_run = os.path.join(model_dir, "Cross-N1024")
    avid = import_criterion_run(avid_run, "cuda")
    run_dir = os.path.join(model_dir, "cma-sharded")
    overrides = LOOP_OVERRIDES + [f"model.model_dir={run_dir}",
                                  f"model.args.checkpoint={avid_run}",
                                  f"loss.args.checkpoint={avid_run}", "loss.bank_sharding=sharded"]
    records = []
    with loop_log(os.path.join(model_dir, "cma_sharded.log"), "run_pretraining (CMA, sharded)"):
        _lib.reset_launches()
        with one_rank_world():
            state = pretrain_main([CMA_LOOP_CONFIG, "--multihost"] + [
                a for o in overrides for a in ("--set", o)], on_epoch=records.append)
        torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    require([(r["epoch"], r["steps"]) for r in records] == [(0, LOOP_STEPS)],
            f"sharded CMA epochs {[(r['epoch'], r['steps']) for r in records]}")
    losses = [v for r in records for v in (r["loss"], r["test_loss"])]
    require(all(v is not None and np.isfinite(v) for v in losses), f"CMA losses {losses}")
    require(launches == EXPECTED_CMA_SHARDED_LAUNCHES,
            f"sharded CMA launches {launches}, expected {EXPECTED_CMA_SHARDED_LAUNCHES}")
    n, pos_k = state.layout.n, state.bank.positive_set.shape[1]
    pos = state.bank.positive_set[:n]
    check_positive_set(pos, n, pos_k)
    rows = torch.arange(n)
    crit = kinetics_cma()
    want = mining.mine_positives(avid.view1_mem, avid.view2_mem, pos_k, crit.sampling_type)
    run_rows = mining_disagreement(pos, want, avid.view1_mem, avid.view2_mem, rows, pos_k,
                                   crit.sampling_type)
    del state, avid

    # the sweep at the CMA slice's size: random unit rows, a one-rank world
    gen = torch.Generator(device="cuda").manual_seed(12)
    n = BANK_ROWS
    bank_v = l2_normalize(torch.randn((n, 128), generator=gen, device="cuda"))
    bank_a = l2_normalize(torch.randn((n, 128), generator=gen, device="cuda"))
    with one_rank_world():
        layout = sharding.BankLayout(n=n, world=mesh.initialize("cuda"), sharded=True)
        shard_v, shard_a = (sharding.shard_rows(m, 0, 1) for m in (bank_v, bank_a))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = mining.mine_positives_sharded(shard_v, shard_a, layout, crit.pos_k,
                                            crit.sampling_type)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    del shard_v, shard_a
    t0 = time.perf_counter()
    want = mining.mine_positives(bank_v, bank_a, crit.pos_k, crit.sampling_type)
    torch.cuda.synchronize()
    replicated_s = time.perf_counter() - t0
    require(not got[n].any(), "the positive set's sentinel row is not zero")
    check_positive_set(got[:n], n, crit.pos_k)
    sweep = mining_disagreement(got[:n], want, bank_v, bank_a, torch.arange(n), crit.pos_k,
                                crit.sampling_type)
    return {"run_rows": rows.shape[0], "run_mining_vs_replicated": run_rows,
            "train_loss": records[0]["loss"], "test_loss": records[0]["test_loss"],
            "mine_s": records[0]["mine_s"], "launches": launches,
            "sweep_rows": n, "sweep_vs_replicated": sweep,
            "sweep_sharded_s": sharded_s, "sweep_replicated_s": replicated_s}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the entry points' backend state (TF32 off, cuDNN autotuning on) from
    # the first phase on: PyTorch caches a convolution's plan under a key
    # without the autotuning flag, so a shape first run untuned (the K5
    # yardstick at the eval batch) would stay untuned in every later phase
    prepare_device("cuda")

    t0 = time.perf_counter()
    _lib.lib()
    build_s = time.perf_counter() - t0
    print("\n".join(_lib.build_log), file=sys.stderr)
    print(json.dumps({"build_s": build_s}), flush=True)

    results: dict = {}
    check_spectrogram(results)
    check_stem_pool(results)
    check_stem_pool_32at16(results)
    torch.cuda.empty_cache()
    check_nce_gather(results)
    check_sharded_primitives(smi)
    torch.cuda.empty_cache()
    check_r2p1d_pair(results)
    check_small_step()
    check_small_step_f32()
    check_small_eval()
    check_small_cma_step()
    torch.cuda.empty_cache()

    run = run_slice()
    print(json.dumps({"card": smi, "config": "Cross-N1024 R2Plus1D-18+Conv2D-10 b32 8x224^2",
                      **run}), flush=True)
    torch.cuda.empty_cache()
    ev = run_eval_slice()
    print(json.dumps({"card": smi, "config": "Cross-N1024 eval (forward only) "
                      "R2Plus1D-18+Conv2D-10 b32 8x224^2 from 240x320", **ev}), flush=True)
    torch.cuda.empty_cache()
    cc = check_crop_color()
    print(json.dumps({"card": smi, "config": "crop+color train preprocessing b32 8x224^2 "
                      "from 256x320, random jitter order", **cc}), flush=True)
    torch.cuda.empty_cache()
    cma = run_cma_slice()
    print(json.dumps({"card": smi, "config": "AVID-CMA InstX-N1024-PosW-N64-Top32 "
                      "R2Plus1D-18+Conv2D-10 b32 8x224^2, N=232067, 1024 negatives (64 "
                      "within), top-32 consensus positives", **cma}), flush=True)
    torch.cuda.empty_cache()
    # the AVID loop phase's run directory is the AVID-CMA loop phase's and
    # the eval loops' warm start; the eval slices point at no run in it
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        no_run = os.path.join(model_dir, "no-run")
        check_small_evals()
        torch.cuda.empty_cache()
        ft = run_finetune_slice(no_run)
        print(json.dumps({"card": smi, "config": "ucf/8at16-fold1.yaml finetune R2Plus1D-18, "
                          "101 classes, dropout 0.5, b64 8x224^2 msc+color from 256x342",
                          **ft}), flush=True)
        torch.cuda.empty_cache()
        ft32 = run_32at16_slice(no_run)
        print(json.dumps({"card": smi, "config": f"ucf/32at16-fold1.yaml finetune R2Plus1D-18, "
                          f"b{BATCH_32AT16} 32x224^2 msc+color from 256x342", **ft32}),
              flush=True)
        torch.cuda.empty_cache()
        pr = run_probe_slice(no_run)
        print(json.dumps({"card": smi, "config": "kinetics/8x224x224-linear.yaml probe, "
                          "frozen R2Plus1D-18, 4 taps, 400 classes, b128 8x224^2 crop+color "
                          "from 256x342", **pr}), flush=True)
        torch.cuda.empty_cache()
        loop = run_loop(model_dir)
        print(json.dumps({"card": smi, "config": "run_pretraining Cross-N1024.yaml "
                          "R2Plus1D-18+Conv2D-10 b32 8x224^2, synthetic 160 clips from "
                          "256x342, threaded loader x4, 1 epoch + resume to 2", **loop}),
              flush=True)
        torch.cuda.empty_cache()
        cma_loop = run_cma_loop(model_dir)
        print(json.dumps({"card": smi, "config": "run_pretraining "
                          "InstX-N1024-PosW-N64-Top32.yaml (AVID-CMA) from the Cross-N1024 "
                          "run, synthetic 160 clips, re-mined every epoch, 1 epoch + resume "
                          "to 2", **cma_loop}), flush=True)
        torch.cuda.empty_cache()
        evl = run_eval_loops(model_dir)
        print(json.dumps({"card": smi, "config": "run_action_recognition ucf/8at16-fold1.yaml "
                          f"(synthetic {FT_VIDEOS} videos, b{FT_BATCH}, 1 warmup + 1 finetune "
                          "epoch, 25-clip final test, dense) and run_linear_probe "
                          f"kinetics/8x224x224-linear.yaml (synthetic {PROBE_VIDEOS} videos, "
                          f"b{PROBE_BATCH}, 1 epoch, dense), each again with test_only, from "
                          "the Cross-N1024 run", **evl}), flush=True)
        torch.cuda.empty_cache()
        proof = run_learning_proof(os.path.join(model_dir, "proof"))
        print(json.dumps({"config": "scripts/learning_proof.py f32 AVID, R2Plus1D-10+Conv2D-10, "
                          "128 train / 64 test learnable instances, b16 8x56^2, "
                          f"{PROOF_EPOCHS} epochs", **proof}), flush=True)
        f32_evals = run_f32_evals(os.path.join(model_dir, "proof"))
        print(json.dumps({"card": smi, "config": "model.dtype float32: run_action_recognition "
                          "ucf/8at16-fold1.yaml and run_linear_probe kinetics/8x224x224-linear.yaml "
                          "(the eval loops' overrides) from the proof's R2Plus1D-10 run, then "
                          "classify of 2 files", **f32_evals}), flush=True)
        torch.cuda.empty_cache()
        audioset = run_audioset_loop(model_dir)
        print(json.dumps({"card": smi, "config": "pretrain_main Cross-N1024.yaml (AudioSet) "
                          "--multihost, one-rank NCCL world, R2Plus1D-18+Conv2D-10 b32 8x224^2, "
                          f"sharded banks of {AUDIOSET_ROWS} rows, synthetic corpus of "
                          f"{AUDIOSET_ROWS} videos, {LOOP_STEPS} steps an epoch, 1 epoch + "
                          "resume to 2; then bank_sharding=replicated, no process group; "
                          "cuDNN deterministic", **audioset}), flush=True)
        torch.cuda.empty_cache()
        cma_sharded = run_cma_sharded(model_dir)
        print(json.dumps({"card": smi, "config": "pretrain_main "
                          "InstX-N1024-PosW-N64-Top32.yaml --multihost, loss.bank_sharding="
                          "sharded, one-rank NCCL world, from the Cross-N1024 run, 1 epoch; "
                          f"the row-sharded sweep at N={BANK_ROWS}", **cma_sharded}), flush=True)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    # each kernel's launches on the main paths: the pretraining entry
    # point's two runs (train steps run K1-K4, its test phases K1, K2, K4
    # and K5), the eval entry points' four runs (K2, K3, K5), all bf16, the
    # f32 learning proof (K1, the f32 forms of K2 and K3, K4, K5) and the
    # f32 evals (the f32 forms of K2 and K3, K5), and the distributed
    # phases: the AudioSet runs (K1-K4, both layouts) and the sharded CMA
    # run (K1-K5)
    launches = {k: sum(p["launches"][k] for p in (loop, evl, proof, f32_evals, audioset,
                                                  cma_sharded))
                for k in KERNELS}
    kernels = []
    for key, meta in KERNELS.items():
        r = results[key]
        kernels.append({**meta, "route": "cuda", "launches": launches[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
