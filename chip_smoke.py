#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, in order (any failure propagates and exits non-zero):
  1. build   — compile the CUDA C++ kernels (``csrc/*.cu``) with ``nvcc``
               into ``build/kernels`` (listed in .gitignore), one compiler per
               source, all started together.
  2. kernel  — the fused InstanceNorm CUDA kernels against their plain
               PyTorch versions: the forward at all nine norm shapes of the
               main path plus C=48 and an odd C, bf16 and f32, ReLU on and
               off, with the regime each shape took; the backward (dx,
               dgamma, dbeta, and without dx) against autograd of the plain
               version at one shape of each regime; one shape twice, bitwise.
  3. forward — the flagship UNet3D at full width (channels 32..512, two
               residual subunits, bf16) on a HECKTOR21 batch [2,48,144,144,2]
               through the kernel; launch count per forward; logits against
               the same weights run through the plain norm.
  4. serving — Tent adapt+segment: 8 steps online (continual, inline
               predictions) and 6 strict (episodic, post-update predictions):
               finite entropy, a gradient in all 36 norm tensors, uint8 predictions
               of the right shape, ms per step and volumes/s; 18 backward
               kernel launches per step and no call of the plain backward.
  5. parity  — one Tent step at full width on a small input, kernel against
               plain norm in f32: entropy, norm-param deltas, predictions.
  6. timing  — the forward and the backward kernel at every norm shape of
               one forward, at batch 2 and at the training batch 8, against
               the plain versions, F.instance_norm+relu (and its autograd)
               and the byte bounds.
  7. min-plus — the CUDA min-plus kernels against their plain versions,
               bitwise, +inf kept, no NaN: ``minplus(f, cost)`` at the
               evaluation path's line shapes and at small and ragged cases;
               ``squared_edt_volumes`` (all volumes and all three axes in one
               launch) for 1, 4 and 8 volumes of [48,144,144] (8: the
               training validation batch's surfaces), ragged volumes,
               all-empty and all-set masks, two spacings, with and without
               the root, one case twice.
  8. EDT     — the squared distance transform through the kernel on a full
               [48,144,144] mask against scipy's on the host, in one launch;
               an empty mask gives +inf everywhere.
  9. eval    — evaluation under adaptation: the flagship UNet3D through
               ``TTAEngine.evaluate`` (Dice/IoU, loss, HD95/ASD/NSD) over 3
               batches of 2 volumes with two domains, for no adaptation,
               episodic Tent and continual Tent: the whole key schema, finite
               values in range, one min-plus launch per batch, Dice equal to
               a numpy recomputation on the host, the model restored after
               every run; an all-empty prediction gets the diagonal penalty;
               the batched surface metrics against the one-pair function,
               pair by pair.
 10. timing  — the distance transform of one evaluated batch (4 surfaces,
               one launch) against its plain version and its bound, the
               general ``minplus`` at the path's two line shapes, a
               register-only probe of the card's add/min rate, and one
               evaluated batch split into forward, Dice/IoU, loss and surface
               metrics (and within those the transform, the sort, the
               surface extraction).
 11. train   — supervised training of the flagship through
               ``ExperimentManager`` with the HECKTOR21 recipe composed from
               configs/ (``train_recipe``) at batch 8: 2 epochs over 16 synthetic
               volumes with validation (4 volumes, surface metrics on) each
               epoch: every step's loss finite, all 82 param tensors moved, 18
               norm forward and 18 backward kernel launches per step and no
               plain backward, each validation batch's min-plus launch
               bitwise its plain version on the same surfaces, the
               checkpoints and sidecar written; a second
               manager resumes through ``training.resume`` with params,
               optimizer state, step, scheduler state and best metrics
               restored bitwise at the right epoch; the flagship's Adam
               state saved and loaded in each format (msgpack, torch, orbax),
               timed; the reference's orbax fixture read bitwise; the
               resumed state saved by ``CheckpointHook(fmt="orbax")`` and
               resumed by a third manager; one step after each restart
               against the same step without it (strict mode), the orbax
               one bitwise with its 18 + 18 norm launches.
 12. train-parity — one f32 training step at full width on a small input,
               kernel against plain norm: loss and parameter deltas.
 13. train-timing — median ms per warm training step at batch 8,
               volumes/s, ms per validation batch, peak allocated memory.
 14. cli     — the command-line entry points as a user runs them
               (``cli_phase``): a HECKTOR21 fixture of 56 NIfTI cases at
               (144,144,48) written by the port; ``cli.train`` of the
               full-width recipe, 2 epochs of 6 steps (enough to spend the
               input path's 2-batch lead), host loader, then again with
               ``training.device_cache=true`` (its batches bitwise the host
               loader's) and ``training.checkpoint_format=orbax``;
               ``cli.adapt`` (Tent, no-adapt report, surface metrics) from
               that run's best orbax checkpoint; ``cli.predict`` (continual
               Tent, probabilities) writing the 4 test cases: 18 + 18 norm
               launches per training step, one min-plus launch per evaluated
               batch, the launches of each call counted exactly, native NIfTI
               decodes only, masks in their source grid.
 15. tta     — every TTA method on phase 11's trained flagship (bf16, full
               width), each stock configs/tta/*.yaml composed into the
               HECKTOR21 recipe (``tta_phase``): tent, continual, pl, eata,
               eata_gate, sar, cotta, cotta_restore, memo and norm, plus SAR
               and EATA with their entropy gates open, SAR with a recovery
               floor that resets it (each reset against the one the traces
               derive), Tent with 4 windows of [32,96,96] and Tent with the
               consistency objective, modality dropout and an early-stop
               floor of 0.999 (a batch frozen at its second step) and Tent
               frozen at every batch's first step (a no-grad tail), each through
               ``TTAEngine.evaluate`` over 4 batches of [2,48,144,144,2]
               (surface metrics on): finite metrics, the model bitwise its
               source afterwards, the norm launches exactly as the step
               structure derives them (``expected_tta_launches``) and one
               min-plus launch per batch, ms per batch; the peak memory of a
               MEMO step (4 views) against a Tent step (at most 1.5x); f32 SAR
               and MEMO steps at full width, kernel vs plain norm; the stream
               through ``cli.adapt`` on phase 14's fixture and checkpoint
               (``stream_phase``): Tent over two centres with
               reset_on_domain_change and the guard, then eata_gate with the
               entropy gate at a probed ``gate.threshold`` (escalates and drops
               back), launches counted exactly.

 16. brats   — the BraTS recipe of train_brats.sh on the mid-fusion UNet at full
               width (channels 32..512, bf16, 4 modalities, 3 regions, remat):
               one forward on [2,160,192,160,4] (52 norm launches, logits
               against the plain norm, domain logits [8,4]); both norm kernels
               against their plain versions at each of its 9 norm shapes, bf16
               and f32, with the regime each took, and timed; training through
               ``ExperimentManager`` (``brats_train_and_serve``: the recipe
               composed from configs/ with modality dropout, 2 epochs of 4
               synthetic volumes, validation with surface metrics: finite
               losses, every tensor moved but the domain head's two, 104 + 52
               launches a step, each validation EDT bitwise its plain
               version, ms a step, volumes/s, peak memory); the trained
               weights through ``TTAEngine.evaluate`` (none, episodic Tent,
               continual Tent, Tent with modality dropout; two domains; the
               launches as ``expected_tta_launches`` derives them with remat),
               one Tent step (all 98 norm tensors get a gradient, its peak
               memory) and the Tent serving step (post, inline); the EDT of an
               evaluated batch's 12 surfaces, one launch, bitwise and timed;
               f32 training steps on [1,64,96,64,4] with and without remat and
               kernel vs plain norm; late fusion, UNet3D-WS and SegResNet at full width
               (``brats_other_models``: 72, 16 and 0 norm launches a forward,
               logits vs plain, a Tent step); ``cli.train`` and ``cli.adapt``
               on a BraTS NIfTI fixture at (96,96,64) (``brats_cli``), each
               call's launches counted exactly.
 17. transformers — UNETR and SwinUNETR at their paper widths
               (configs/model/{unetr,swin_unetr}.yaml in the HECKTOR21 recipe,
               bf16): one forward on [2,48,144,144,2] (16 and 22 norm launches,
               267 / 238 param tensors of which Tent adapts 82 / 94; logits
               against the plain norm, and in f32); both norm kernels against
               their plain versions at every norm shape of that forward, bf16
               and f32, with the regime each took, and timed; training through
               ``ExperimentManager`` with the recipe at batch 8 and remat
               (``transformer_train_and_serve``: 2 epochs of 16 synthetic
               volumes, validation with surface metrics: finite losses, every
               tensor moved, the launches of every step as remat derives them
               (``remat_norms``: UNETR's skip branches are never recomputed),
               each validation EDT bitwise its plain version, ms a step,
               volumes/s, peak memory); ``TTAEngine.evaluate`` with none,
               episodic Tent and continual Tent (launches as
               ``expected_tta_launches`` derives them, the model restored);
               the Tent serving step online and strict; an f32 Tent step on a
               small full-width input, kernel vs plain norm; ``cli.train``,
               ``cli.adapt`` and ``cli.predict`` with ``model=<name>`` on
               phase 14's fixture (``transformer_cli``), each call's launches
               counted exactly.

 18. batchnorm — BatchNorm (``batchnorm_flagship``, ``batchnorm_cli``,
               ``classifier_phase``): the flagship with ``model.norm=BATCH``
               at full width (bf16): training steps at batch 8 on device
               batches (median of 8 warm, peak memory; the running
               statistics move every step), a remat step moving them as a
               plain step does (once), a checkpoint round trip bitwise with
               its buffers, one ``norm`` step's running statistics against
               ``0.9 ra + 0.1 (mean, biased var)`` in f64 on the host,
               ``TTAEngine.evaluate`` for none, norm (episodic, continual)
               and Tent (episodic post, continual inline) over 3 batches of 2
               (one min-plus launch per batch, each batch's EDT bitwise its
               plain version, no norm launch, params and buffers bitwise
               afterwards), the Tent serving step; ``cli.train`` with
               ``model.norm=BATCH`` on phase 14's fixture and ``cli.adapt``
               with norm, tent, sar, cotta and memo on its checkpoint, each
               call's launches exactly; ResNet-50 in Tent's ImageNet-C
               setting (batch 64 of 224x224, SGD 2.5e-4, continual, bf16 and
               f32: ms per step, peak memory), one step of norm, sar, memo
               and cotta on it, each family's registry default
               (resnet18, densenet121, efficientnet_b0, efficientnet_v2_s,
               vit_b_16) loaded through ``model.pretrained`` from a
               torchvision-named file and run at batch 16, and ResNet-50's
               f32 logits, affine deltas and statistics after a Tent step
               against the port on the CPU.
 19. serving — the serving artifact (``serving/export.py``,
               ``serving_artifact_phase``) on the flagship at full width (bf16,
               random weights from a seed, batches of [2,48,144,144,2],
               threshold 0.3): Tent's continual-inline and episodic-post steps
               (the stock tent.yaml) exported with ``torch.export`` on the
               card, saved, loaded and run over 8 and 6 batches against the
               live ``make_adapt_predict_fn`` on the same weights, batches and
               draws (predictions on 99.9% of voxels, entropies, the adapted
               norm tensors, the frozen params bitwise), the norm operator
               calls the program holds and each call's launches exactly (18 +
               18 and 36 + 18, no plain backward), ms per step of both, and
               one more call of each under the profiler (device time, the
               host calls that take the most host time); SAR,
               CoTTA and MEMO one batch each; the forward artifact against
               ``_probs_fn`` (18 launches); ``cli.export_serving`` from phase
               14's checkpoint and ``cli.serve_artifact`` on 3 of its fixture's
               cases (every row ok, uint8 masks in the source grid, 18 + 18
               launches a batch); export seconds and bytes of each artifact
               (SAR's, CoTTA's and MEMO's programs run from memory).

 20. options — the training options (``training_options_phase``): through
               ``ExperimentManager`` with the HECKTOR21 recipe at batch 8 on
               [8,48,144,144,2], bf16, 2 epochs of 16 synthetic volumes with
               validation of 4 (surface metrics) each: A, UNETR at
               configs/model/unetr.yaml's widths with 8 experts in blocks 1, 3,
               .., 11 and remat, once with Adam and once with the stock
               adafactor block; B, the flagship with deep supervision 2; C,
               UNet3D-WS distilled from phase 11's flagship checkpoint (focus
               all, then uncertain); D, the flagship's bottleneck MoE, its
               steps 1-2 traced by ``training.profile``: finite losses, every
               trainable tensor moved, the teacher bitwise its checkpoint, each
               step's launches and the run's exactly (``OPTION_NORMS``,
               ``remat_norms``, the teacher's 18), each validation EDT bitwise
               its plain version, the MoE aux and dropped share of every step,
               the top-1 routing of a bf16 forward through the kernel and the
               plain norm, ms per warm step, volumes/s, peak memory and the
               optimizer state's bytes; one f32 step of each on a small
               input, kernel vs plain norm (phase 12's limits); the trace's 2
               ``ProfilerStep``s and the norm kernels' names; then
               ``training.debug_nans`` on B: two clean steps (strict mode)
               bitwise the flag-off steps and what the checks cost a step,
               a batch with a NaN raising ``FloatingPointError``.
 21. preprocess — the offline preprocessing on the card (``preprocess_phase``):
               a raw HECKTOR21 tree written from seeds at HECKTOR 2021's grids
               (6 cases over CHGJ, CHUS and the target CHUP: CT 512x512x128
               int16 at 0.977 x 0.977 x 3 mm, PET 200x200x128 f32 at 4.07 x
               4.07 x 3 mm with another origin, the GTVt, a 144 mm bbox;
               uncompressed .nii through the config's suffix keys) through
               ``cli.prepare_hecktor21`` (the stock geometry: [1, 1, 3] mm,
               [144, 144, 48]): ms per case by part (decode, the CT, PET and
               GTVt resamples, crop/pad, encode and write), cases/s, the
               resample's ms per CT and peak memory, no kernel launched; its
               first case again on the CPU (labels equal, images within
               1e-5 of their range, affines and the manifest row equal); 2
               BraTS cases (four int16 modalities and seg at 240x240x155, 1 mm)
               through ``cli.prepare_brats`` to [160, 192, 160], one again on
               the CPU, held the same way; the prepared manifest through
               ``cli.train`` (one epoch at batch 2, validation with surface
               metrics) and ``cli.adapt`` (Tent on CHUP, the no-adapt report):
               18 + 18 launches a step, 18 a validation batch, 54 + 18 a test
               batch, each call's launches exactly, each EDT bitwise its plain
               version; then the ops nothing calls (``unused_ops_phase``), card
               vs CPU: SSIM and MS-SSIM of a prepared CT/PET pair (3D, three
               scales) and of a [64,224,224,3] pair, ``rand_rot90`` on
               [8,48,144,144,2] (bitwise), focal and triplet losses with their
               gradients, ``vae_delta_mog`` at its default widths (channels
               32..512, 64x64, K = 16) at batch 64.
 22. data_parallel — the data axis over ranks (``data_parallel_phase``): a
               probe of NCCL with two ranks on card 0 (its answer printed;
               it refuses, so the two-rank runs name ``gloo`` before they
               start), then two ranks spawned on card 0
               (``training.devices=[0, 0]``) against one process on the same
               global batches, the flagship at full width: 2 training steps
               of the HECKTOR21 recipe in f32 at global batch 8 (4 a rank)
               with zero1 and the sharded device cache, one validation batch
               of 3 (ragged), Tent online (continual, inline) and strict
               (episodic, post) over 2 batches of 2, ``TTAEngine.evaluate``
               with continual Tent over batches of 2, 2 and 1 — losses,
               the first step's gradients (with a witness: one process's
               two half-batch passes), metrics, entropies, predictions and
               adapted tensors within ``DP_*``, each rank's launches
               exactly, each rank's norm kernels at every input its path
               gave them and its EDTs against their plain versions, rank
               0's checkpoints (zero1 consolidated); the bf16
               training and Tent steps' ms per rank against one process, the
               bytes all-reduced per step, the optimizer state with zero1
               against without, peak memory; then ``cli.train`` and
               ``cli.adapt`` on phase 14's fixture under
               ``python -m torch.distributed.run --nproc_per_node=1`` (NCCL,
               one rank). Two ranks on one card show the collectives' cost,
               not scaling.
 23. space_parallel — the space axis over ranks (``space_parallel_phase``):
               two ranks spawned on card 0 over gloo on a ``data=1 x
               space=2`` mesh (each rank every row and half the depth)
               against one process on the same global batches: the
               flagship at full width, 3 f32 training steps of the recipe at
               global batch 8 and a validation batch, Tent online and strict
               on batches of 2, ``TTAEngine.evaluate`` with continual Tent;
               one f32 training step of the mid-fusion UNet at BraTS size
               with remat — losses, the first steps' gradients summed over
               the ranks, metrics, entropies, predictions and adapted
               tensors within ``SP_*``, each rank's launches exactly, every
               call of the four split norm entries held to its plain version
               as the path makes it (``SplitCheck``: the f32 path, then the
               first bf16 training and Tent steps), the EDTs bitwise, peak
               memory a rank against one process; bf16 ms per training and
               Tent step and the collectives' calls and bytes; then
               ``cli.train``, ``cli.adapt`` and ``cli.predict`` under
               ``python -m torch.distributed.run --nproc_per_node=2`` with
               ``training.mesh.space=2``, the export held byte for byte to
               one process's from the same checkpoint
               (``sp_predict_check``); and the split entries against their
               plain versions in f32 and bf16, and timed, at the 14 split
               norm shapes of a batch-8 training forward. Its evaluation
               and adaptation over a split depth (``space_adapters_phase``,
               a job of the same spawn): ``TTAEngine.evaluate`` with pl,
               eata, sar, cotta and memo, Tent with windows, flip TTA and
               the sliding window on one full-width batch against one
               process, each rank's launches exactly, every kernel call
               held to its plain version, ms, peak and collective bytes
               per case.
               Its transformers (``space_transformers_phase``, a job of the
               same spawn): UNETR and SwinUNETR at ``configs/model/``'s
               widths on one HECKTOR21 batch (a forward, an SGD step, a
               continual Tent step, an evaluated batch) and UNETR with
               ``seq_shard_axis=space`` on one BraTS volume (a forward, an
               SGD step), f32, against one process: logits, losses, the
               first step's gradients, Tent's moves, predictions, metrics;
               each rank's launches exactly, every kernel call held to its
               plain version.
 24. adapters — pl, eata, sar, cotta and memo over two ranks on card 0
               against one process (``adapters_phase``), every norm and
               min-plus call held to its plain version (``CallCheck``).
 25. model_axis — UNETR (8 blocks) over ``data=2 x model=2``
               (``model_axis_phase``).
 26. expert_axis — MoE UNETR (8 blocks, 8 experts, remat, f32) over
               four ranks on card 0 on ``data=2 x expert=2``
               (``expert_axis_phase``), each rank holding 4 of the 8 experts
               of every MoE block and their Adam moments, against one
               process on the same global batches: a forward, two training
               steps with Adam and with Adafactor, Tent online and strict,
               one evaluated batch with the surface metrics; every norm
               and min-plus call held to its plain version, launches exact,
               the ranks of a data group bit for bit; bytes over the expert
               and data groups, ms, peaks.
 27. stage_axis — ViT-B/16 on [64,224,224,3] over four ranks on card 0 on
               ``data=2 x stage=2`` (``stage_axis_phase``, GPipe,
               ``n_micro=4``) against the sequential model: the pipelined
               forward's logits, two ``make_pipeline_train_step`` SGD steps
               on the trunk (loss, stacked gradients, the loss falling),
               each stage holding 6 blocks; ms against sequential, the
               bubble, bytes a hop.
 27b. space_axes — a space axis beside the model, expert and stage axes
               (``space_axes_phase``, a job of the same spawn, one mesh a
               case): UNETR with ``tp_axis=model`` and the sequence axis on
               one BraTS volume over ``space=2 x model=2`` (4 blocks), the
               flagship with 4 bottleneck experts on one HECKTOR21 batch
               over ``space=2 x expert=2`` (the routing bitwise), a forward
               and an SGD step each against one process, every norm call
               held to its plain version, launches exact; ViT-B/16 pipelined
               over ``space=2 x stage=2``, one GPipe step against phase
               27's sequential run, its forward and step ms.

Phase 2 also holds the norm kernels against their plain versions at the nine
norm shapes of the batch-8 training step (the largest, [8,48,144,144,32], in
bf16 and f32) and at the nine shapes of windowed Tent's 4 windows.

The line before the last is the kernel summary ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Weights and data are random,
made from fixed seeds. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # non-tensor-core f32, counted as fused multiply-adds
# an add and a min per (r, i, j) cannot fuse into one FMA: half the f32 figure
FP32_ADDMIN_OPS = FP32_FLOPS / 2
# tolerances of kernel vs plain: f32 — same arithmetic, other summation
# order over up to 1M elements; bf16 — one bf16 rounding step of the output
TOL_F32 = dict(atol=5e-5, rtol=0.0)
TOL_BF16 = dict(atol=5e-2, rtol=2.0 ** -7)
LOGITS_REL_L2 = 1e-2  # full-width bf16 forward, kernel vs plain norm
# backward kernel vs autograd of the plain version. f32 sums (dgamma, dbeta)
# and f32 dx: other summation order. bf16 dx: one bf16 rounding of dx.
GRAD_F32_REL, GRAD_F32_ABS = 1e-4, 1e-5  # limit = REL * max|ref| + ABS
DX_BF16_REL = 2.0 ** -7  # limit = REL * (max|ref| + |ref|)
KINK_MARGIN = 1e-4  # the checks' inputs keep |pre-activation| above this

HECKTOR_POLICY = {
    "enabled": True,
    "channel_names": ["ct", "pt"],
    "channels": {
        "ct": {"clip": [-1000, 1000], "zscore": {"masked": True, "mask_gt": -900, "eps": 1e-6}},
        "pt": {"clip": [0.0, 15.0], "zscore": {"masked": True, "mask_gt": 0.0, "eps": 1e-6}},
    },
}
DEVICE_TRANSFORM = {"normalize": True, "intensity_policy": HECKTOR_POLICY, "channel_names": ["ct", "pt"]}
SHAPE = (48, 144, 144, 2)
BATCH = 2
TRAIN_BATCH = 8  # the training recipe's batch (configs/training/default.yaml)
THRESHOLD = 0.3
SPACING = (3.0, 1.0, 1.0)  # HECKTOR21, mm
WINDOWS, WINDOW_ROI = 4, (32, 96, 96)  # configs/tta/tent.yaml window: windows_per_step, roi_size
TTA_BATCHES = 4  # phase 15: batches per run (EATA's Fisher window is 4)
NSD_TOL = 2.0
DOMAINS = (["CHUM", "CHGJ"], ["CHGJ", "CHGJ"], ["CHUM", "CHUM"])
EDT_REL_TOL = 1e-5  # squared EDT vs scipy: f32 sums of squares against f64
DICE_ABS_TOL = 1e-5  # device f32 Dice vs numpy f64 on the same masks
# batched surface metrics vs the one-pair function on the card: HD95 and NSD
# equal; ASD within this relative step (f64 sums reduced over another shape,
# rounded once to f32)
ASD_REL_TOL = 2.0 ** -23
# training: one step after a restart vs without it, in strict mode (the same
# state and deterministic algorithms: bitwise expected), relative to max|p|
RESUME_STEP_REL = 1e-6
# a full-width f32 training step, kernel vs plain norm (phase 5's limits):
# loss relative; parameter deltas relative L2 (18 norms' sums in another order)
TRAIN_LOSS_REL, TRAIN_DELTA_REL = 1e-4, 1e-3


def eval_config(method: str, episodic: bool, threshold: float = THRESHOLD) -> dict:
    return {
        "task": {"seed": 0, "eval_strategy": "seg_eval"},
        "dataset": {"modality_order": ["ct", "pt"]},
        "training": {"criterion": {"sigmoid": True},
                     "data": {"transforms": {"on_device": True, "normalize": True,
                                             "intensity_policy": HECKTOR_POLICY}}},
        "evaluation": {"seg": {"region_order": ["gtvt"], "threshold": threshold,
                               "spacing": list(SPACING)},
                       "surface": {"enable": True, "nsd_tol": NSD_TOL},
                       "loss": {"report_loss": True}},
        "tta": {"method": method, "steps": 1, "lr": 1e-3, "optimizer": "sgd", "momentum": 0.9,
                "update": "norm", "episodic": episodic},
    }


def train_overrides(save_dir: str) -> list:
    """Phase 11's command-line overrides of the HECKTOR21 recipe: 2 epochs,
    scheduler poly, validation (surface metrics on) and a checkpoint every
    epoch, seed 0; the run directory given, so that nothing reads the clock."""
    return ["task=hecktor21", "dataset=hecktor21", "model=unet", "task.seed=0", f"task.save_dir={save_dir}",
            f"hydra.run.dir={save_dir}", "training.epochs=2", "training.scheduler.name=poly",
            "training.model_save_start=0", "training.model_save_freq=1", "training.eval_test.every_n_epochs=1",
            "evaluation.surface.enable=true", f"evaluation.surface.nsd_tol={NSD_TOL}"]


def train_recipe(save_dir: str) -> dict:
    """The HECKTOR21 training recipe as the port composes it from configs/
    (configs/training/default.yaml with configs/_global_patches/hecktor21.yaml:
    adam lr 1e-5, weight decay 5e-4 outside the no-decay groups, betas (0.9,
    0.9999); DiceCE with lambda_dice 5, ce_weight [50], sigmoid; batch 8, bf16
    compute, f16 transfer, the intensity policy on the device) with
    ``train_overrides``."""
    from multimodal_tta_tpu_torch.conf import compose

    return compose(os.path.join(REPO, "configs"), "config", train_overrides(save_dir)).to_container()


# phase 14: a HECKTOR21 fixture at the recipe's shape, (X,Y,Z) on disk; 48
# training volumes (six steps of batch 8 an epoch: the host loader's steady
# rate shows once its 2-batch lead is spent), 4 validation, 4 test
CLI_SHAPE = (144, 144, 48)
CLI_CENTERS = {"CHUS": 4, "CHUM": 26, "CHGJ": 26}
CLI_STEPS_PER_EPOCH = 6


def saved_state_dict(path: str) -> dict:
    """The params and buffers of the msgpack (or, without one, orbax)
    checkpoint at the extension-less ``path`` (the reference's formats), as
    a state dict."""
    from multimodal_tta_tpu_torch.core import flax_msgpack, orbax_format
    from multimodal_tta_tpu_torch.models.convert import variables_from_flax

    if os.path.exists(path + ".msgpack"):
        raw = flax_msgpack.load(path + ".msgpack")
    else:
        raw = orbax_format.load(path + ".orbax")
    return variables_from_flax({"params": raw["params"], "batch_stats": raw["batch_stats"]})


def tree_bytes(path: str) -> int:
    """The bytes of a file, or of every file under a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(path) for n in ns)


ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "orbax_reference")


ORBAX_FIXTURE_PASSES = 20  # the fixture's frames are small: 20 passes make the decode time readable


def orbax_fixture_check() -> dict:
    """The reference's orbax checkpoint committed in ``tests/data``
    (``scripts/make_orbax_fixture.py``: the JAX package's
    ``save_checkpoint_sharded``, tensorstore's level-1 zstd frames) read by
    ``core/orbax_format.py``: every leaf against ``expected.npz`` bitwise,
    the decoder's counts of the frame modes it met, and the decode rate of
    those frames (``ORBAX_FIXTURE_PASSES`` times over, one thread)."""
    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.core import ocdbt, orbax_format, zstd

    zstd.reset_counters()
    stats = {}
    payload = orbax_format.load(os.path.join(ORBAX_FIXTURE, "ckpt.orbax"), stats=stats)
    modes = {k: v for k, v in zstd.counters().items() if v}
    want = np.load(os.path.join(ORBAX_FIXTURE, "expected.npz"))
    got = {}
    for keys, v in orbax_format.flatten(payload):
        if not isinstance(v, str):
            got[".".join(k for k, _ in keys)] = (v.view(torch.uint16) if v.dtype == torch.bfloat16 else v).numpy()
    bitwise = sorted(got) == sorted(want.files) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes()
        for k in want.files)
    with ocdbt.Database(os.path.join(ORBAX_FIXTURE, "ckpt.orbax")) as db:
        frames = [db.read(e) for e in db.entries() if not e.key.endswith(b".zarray")]
    out = bytearray(max(v.nbytes for v in got.values()))  # room for the largest chunk
    t0 = time.perf_counter()
    decoded = 0
    for _ in range(ORBAX_FIXTURE_PASSES):
        for frame in frames:
            decoded += zstd.decompress_into(frame, out)
    decode_s = time.perf_counter() - t0
    return {"leaves": len(want.files), "chunks": stats["chunks"], "bytes": stats["bytes"], "bitwise": bitwise,
            "modes": modes, "passes": ORBAX_FIXTURE_PASSES, "decode_MBps": decoded / decode_s / 1e6}


CKPT_FORMATS = (("msgpack", ".msgpack"), ("torch", ".pt"), ("orbax", ".orbax"))


def checkpoint_io(src, dst, path: str, check) -> dict:
    """``src`` (a train state) saved at the extension-less ``path`` in each
    format and loaded into ``dst``, timed (the file cache warm: the file was
    just written); ``check(state)`` says whether the state loaded equals
    ``src``'s bitwise. For orbax the reader's chunk decoding (the native
    zstd, ``orbax_format.THREADS`` threads) is timed apart. The files are
    removed. Returns ``{format: {bytes, save_s, load_s, save_MBps,
    load_MBps, restored[, chunks, decoded_bytes, decode_s, decode_MBps]}}``."""
    import shutil

    import torch

    from multimodal_tta_tpu_torch.core import orbax_format
    from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    out = {}
    for fmt, ext in CKPT_FORMATS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, src, fmt=fmt)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = load_checkpoint(path, dst)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = tree_bytes(path + ext)
        out[fmt] = {"bytes": size, "save_s": save_s, "load_s": load_s, "save_MBps": size / save_s / 1e6,
                    "load_MBps": size / load_s / 1e6, "restored": bool(check(got))}
        if fmt == "orbax":
            stats = {}
            orbax_format.load(path + ext, stats=stats)
            out[fmt].update(decoded_bytes=stats["bytes"], chunks=stats["chunks"], decode_s=stats["decode_s"],
                            decode_MBps=stats["bytes"] / stats["decode_s"] / 1e6)
            shutil.rmtree(path + ext)
        else:
            os.remove(path + ext)
    return out


def rewrite_check(state, ckpt: str, path: str) -> dict:
    """``state``, restored from the msgpack checkpoint ``ckpt`` by the
    caller, written again to ``path``: whether the two files are the same
    bytes (read then write is the identity), the bytes and the seconds."""
    from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint

    t = time.perf_counter()
    save_checkpoint(path, state)
    save_s = time.perf_counter() - t
    with open(ckpt + ".msgpack", "rb") as f:
        a = f.read()
    with open(path + ".msgpack", "rb") as f:
        b = f.read()
    return {"bytes": len(a), "identical": a == b, "save_s": save_s}


def hecktor_volumes(n: int, seed: int, shape=SHAPE[:3]) -> list:
    """CT/PET-like volumes [*shape, 2] with an ellipsoid lesion each (its
    centre and radii scale with ``shape``)."""
    import numpy as np

    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")

    def scaled(v):
        return tuple(a * n_ / full for a, n_, full in zip(v, shape, SHAPE[:3]))

    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        c, rad = r.uniform(scaled((14, 40, 40)), scaled((34, 104, 104))), r.uniform(scaled((3, 8, 8)),
                                                                                     scaled((8, 24, 24)))
        lesion = (((zz - c[0]) / rad[0]) ** 2 + ((yy - c[1]) / rad[1]) ** 2 + ((xx - c[2]) / rad[2]) ** 2) <= 1.0
        ct = r.randn(d, h, w).astype(np.float32) * 150.0 - 50.0 + 250.0 * lesion
        ct[r.rand(d, h, w) < 0.3] = -1000.0  # air
        pt = np.abs(r.randn(d, h, w)).astype(np.float32) * 1.5 + 8.0 * lesion
        out.append({"image": np.stack([ct, pt], axis=-1).astype(np.float32),
                    "label": lesion[..., None].astype(np.float32), "domain": ("CHUM", "CHGJ")[i % 2]})
    return out


def cli_overrides(manifest: str, run_dir: str, *extra: str, model: str = "unet") -> list:
    """The overrides of every phase-14 CLI call: the full-width recipe of
    configs/ on the fixture (``model`` of configs/model/), target centre CHUS,
    2 validation volumes per source centre, 2 epochs with validation (surface
    metrics on) and a checkpoint each epoch."""
    return ["task=hecktor21", "dataset=hecktor21", f"model={model}", f"dataset.manifest_csv={manifest}",
            "dataset.target_center=CHUS", "dataset.val_per_center=2", "training.epochs=2",
            "training.model_save_start=0", "training.model_save_freq=1", "training.eval_test.every_n_epochs=1",
            "evaluation.surface.enable=true", f"task.save_dir={os.path.dirname(run_dir)}",
            f"hydra.run.dir={run_dir}", *extra]


_LIVE = set()  # the processes run_command started that have not ended
# what the forkserver the ranks of phases 22-27 are forked from imports
# once (``start_rank_server``); a fresh process takes 6-8 s to import
# torch on the card's host
RANK_PRELOAD = ("__main__", "numpy", "torch", "multimodal_tta_tpu_torch.core", "multimodal_tta_tpu_torch.evaluation",
                "multimodal_tta_tpu_torch.models", "multimodal_tta_tpu_torch.parallel", "multimodal_tta_tpu_torch.tta")


def start_rank_server() -> None:
    """Start the forkserver that ``spawn_ranks`` forks the ranks of phases
    22-27 from, with ``RANK_PRELOAD`` imported in the background (it never
    touches the card)."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    mp.get_context("forkserver").set_forkserver_preload(list(RANK_PRELOAD))
    forkserver.ensure_running()


def run_command(cmd: list, timeout: float, env=None) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
    timeout=timeout)`` (``env``: variables set on top of this process's),
    with the process kept where ``stop_commands`` can end it from another
    thread."""
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=None if env is None else {**os.environ, **env})
    _LIVE.add(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()  # torchrun ends its ranks on SIGTERM
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise
    finally:
        _LIVE.discard(proc)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def stop_commands() -> None:
    """End every process ``run_command`` started that still runs."""
    for proc in list(_LIVE):
        proc.terminate()
    for proc in list(_LIVE):
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


class CliLane:
    """Phase 22's NCCL probe and the torchrun command lines of phases 22-24
    (``dp_torchrun_cli``, ``sp_torchrun_cli``, ``ad_torchrun_cli``), run one
    after another on a thread of their own while this process goes on with
    phases 15-21: each job is mostly the start of fresh processes (the
    launcher's and each rank's imports, each rank's first kernels) and
    writes under its own root. ``result(name)`` waits for the lane and returns that job's result
    or raises its error; ``stop()`` ends what still runs."""

    def __init__(self, jobs: dict):
        import threading

        self.results, self.seconds = {}, {}
        self.t0 = time.perf_counter()
        self.wall_s = None
        self._thread = threading.Thread(target=self._run, args=(dict(jobs),), name="cli-lane", daemon=True)
        self._thread.start()

    def _run(self, jobs: dict) -> None:
        for name, job in jobs.items():
            t = time.perf_counter()
            try:
                self.results[name] = job()
            except BaseException as e:  # raised again by result(name)
                self.results[name] = e
            self.seconds[name] = time.perf_counter() - t
        self.wall_s = time.perf_counter() - self.t0

    def join(self) -> float:
        """Wait for the lane; the seconds this process waited."""
        t = time.perf_counter()
        self._thread.join()
        return time.perf_counter() - t

    def result(self, name: str):
        self._thread.join()
        got = self.results[name]
        if isinstance(got, BaseException):
            raise AssertionError(f"the CLI lane's {name} job failed: {type(got).__name__}: {got}") from got
        return got

    def stop(self) -> None:
        stop_commands()
        self._thread.join(timeout=60)


def cli_phase(device, root: str, *, shape=CLI_SHAPE, centers=CLI_CENTERS, extra=(),
              reset_counts=lambda: None, read_counts=lambda: {}) -> dict:
    """Phase 14: the port's command-line entry points end to end, as a user
    runs them: write a HECKTOR21 fixture, train (``cli.train``) with the host
    loader and again with ``training.device_cache=true`` and
    ``training.checkpoint_format=orbax``, adapt with Tent from the second
    run's best (orbax) checkpoint (``cli.adapt``), export masks
    (``cli.predict``) from the first run's.

    Checks what holds on any device: the run directories, logs and
    ``.msgpack`` (the stock configs' format) and ``.orbax`` checkpoints;
    finite losses; the device cache's batches bitwise the host
    loader's (order and f16 / uint8 values); the ``tta_metrics.json`` schema
    and ranges; the model restored after adapt and predict; every case
    exported with its source's grid and mask == prob >= threshold; every
    NIfTI decode on the native path. ``read_counts`` (kernel launch counts,
    zeroed by ``reset_counts`` just before each CLI call) is read per training
    step and after each call; the caller holds them against what the path
    must launch. ``extra`` is appended to every CLI call's overrides. The
    fixture and the runs stay under ``root`` (``out["manifest"]``,
    ``out["best"]``: phase 15's stream runs on them); the caller removes
    it."""
    import csv
    import shutil
    import statistics

    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.cli import adapt, predict, train
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.data import _native, nifti
    from multimodal_tta_tpu_torch.data.device_cache import DeviceCachedLoader
    from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    shutil.rmtree(root, ignore_errors=True)
    out: dict = {"device": str(dev)}
    t0 = time.perf_counter()
    manifest = make_hecktor_fixture(os.path.join(root, "data"), shape=tuple(shape), centers=dict(centers), seed=7)
    out["fixture_s"] = time.perf_counter() - t0
    out["fixture_bytes"] = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(os.path.join(root, "data"))
                               for n in ns)
    with open(manifest, newline="", encoding="utf-8") as f:
        cases = {r["patient_id"]: r for r in csv.DictReader(f)}
    ct0 = next(iter(cases.values()))["ct_proc"]
    t0 = time.perf_counter()
    if not _native.available():  # builds csrc/nifti_native.cpp with g++ into build/native/
        raise AssertionError(f"the native NIfTI decoder did not build: {_native.build_log()}")
    out["native_build_s"] = time.perf_counter() - t0
    decode_ms = {}
    for path_name, fn in (("native", nifti.load_canonical_dhw),
                          ("python", lambda p: np.ascontiguousarray(nifti.load_canonical(p).transpose(2, 1, 0)))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(ct0)
            times.append((time.perf_counter() - t0) * 1e3)
        decode_ms[path_name] = statistics.median(times)
    out["decode_ms_per_volume"] = decode_ms
    nifti.decode_counts.reset()

    managers, recorders = [], []

    class StepRecorder(HookBase):
        """Per training step: kernel launches, the loss (read one step late by
        the trainer), the wall since the previous step ended (the first step
        of an epoch from the epoch's start: the input path's first batch
        included), and the batch it was given."""

        def __init__(self):
            self.launches, self.losses, self.ms, self.first, self.batches, self.epoch_s = [], [], [], [], [], []

        def before_train_epoch(self):
            sync()
            self._t = self._epoch_t = time.perf_counter()
            self._first = True

        def on_epoch_end(self, *args):  # registered last: after validation and the checkpoint writes
            sync()
            self.epoch_s.append(time.perf_counter() - self._epoch_t)

        def before_train_step(self):
            self._at = read_counts()

        def after_train_step(self):
            sync()
            now = time.perf_counter()
            self.ms.append((now - self._t) * 1e3)
            self.first.append(self._first)
            self._t, self._first = now, False
            got = read_counts()
            self.launches.append({k: got[k] - self._at[k] for k in got})
            self.losses.append(self.trainer._pending_loss)

    orig_setup_optimizer, orig_setup_trainer = ExperimentManager.setup_optimizer, ExperimentManager.setup_trainer

    def setup_optimizer(self):  # every CLI calls it once: the manager it built
        managers.append(self)
        return orig_setup_optimizer(self)

    def setup_trainer(self, *args, **kwargs):
        orig_setup_trainer(self, *args, **kwargs)
        rec = StepRecorder()
        self.trainer.register_hooks([rec])
        run_step = self.trainer.run_step

        def recording_step(batch):
            rec.batches.append((batch["image"].clone(), batch["label"].clone()))
            return run_step(batch)

        self.trainer.run_step = recording_step
        recorders.append(rec)

    def run(cli, name: str, *args: str):
        """One CLI call from the repository root, its launches counted from 0."""
        run_dir = os.path.join(root, "runs", name)
        reset_counts()
        t0 = time.perf_counter()
        try:
            result = cli.main(cli_overrides(manifest, run_dir, *args, *extra), device=dev)
            sync()
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        return result, run_dir, time.perf_counter() - t0, read_counts()

    ExperimentManager.setup_optimizer, ExperimentManager.setup_trainer = setup_optimizer, setup_trainer
    try:
        runs = {}
        # the second run writes the reference's orbax format, which cli.adapt reads below
        for name, args, fmt in (("train", (), "msgpack"),
                                ("train_device_cache", ("training.device_cache=true",
                                                        "training.checkpoint_format=orbax"), "orbax")):
            history, run_dir, wall, counts = run(train, name, *args)
            m, rec = managers[-1], recorders[-1]
            written = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            want = sorted(f"{n}.{e}" for n in ("best_model", "checkpoint_epoch_0", "checkpoint_epoch_1")
                          for e in ("json", fmt))
            if written != want or not os.path.isfile(os.path.join(run_dir, "train.log")):
                raise AssertionError(f"{name}: checkpoints {written}, run dir {sorted(os.listdir(run_dir))}")
            losses = [float(v) for v in rec.losses]
            if not losses or not all(np.isfinite(losses)) or not all(
                    np.isfinite(h["loss"]) for h in history["train_history"]):
                raise AssertionError(f"{name}: losses {losses}")
            n_train = len(m.train_loader.dataset)
            input_ms = []  # the input path alone, as the trainer consumes it: ms per batch, one epoch
            for _ in range(2):
                sync()
                t0, n = time.perf_counter(), 0
                for batch in m.trainer._wrap_loader(m.train_loader):
                    n += 1
                sync()
                input_ms.append((time.perf_counter() - t0) * 1e3 / n)
            del batch
            starts = [i for i, f in enumerate(rec.first) if f] + [len(rec.ms)]
            runs[name] = {"wall_s": wall, "steps": len(losses), "steps_per_epoch": len(m.train_loader),
                          "losses": losses, "step_launches": rec.launches, "launches": counts, "step_ms": rec.ms,
                          # an epoch's first step also waits for the loader's first batches
                          "median_step_ms": statistics.median([t for t, f in zip(rec.ms, rec.first) if not f]),
                          "first_step_ms": [t for t, f in zip(rec.ms, rec.first) if f],
                          # what an epoch costs a step, its first included: the input path's steady rate
                          "epoch_ms_per_step": [statistics.fmean(rec.ms[a:b]) for a, b in zip(starts, starts[1:])],
                          "epoch_s": rec.epoch_s, "input_alone_ms_per_batch": input_ms,
                          "val_batches": 2 * len(m.val_loader), "train_volumes": n_train, "format": fmt,
                          "val_metrics": [{k: v for k, v in ev.items() if "/" not in k}
                                          for ev in history["eval_history"]]}
            if isinstance(m.train_loader, DeviceCachedLoader):
                runs[name].update(store_bytes=m.train_loader.store_bytes,
                                  stage_s=m.train_loader.stage_seconds)
        host, cached = recorders[0].batches, recorders[1].batches
        same = len(host) == len(cached) > 0 and all(
            a[0].dtype == b[0].dtype == torch.float16 and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(host, cached))
        if not same or not isinstance(managers[1].train_loader, DeviceCachedLoader):
            raise AssertionError("the device cache's batches are not the host loader's")
        runs["train_device_cache"]["batches_bitwise_host_loader"] = same
        del host, cached, recorders[:]
        out.update(runs)
        best = os.path.join(root, "runs", "train", "checkpoints", "best_model")
        best_orbax = os.path.join(root, "runs", "train_device_cache", "checkpoints", "best_model")
        out.update(manifest=manifest, best=best)
        source = saved_state_dict(best)
        source_orbax = saved_state_dict(best_orbax)

        def restored(m, want=source) -> bool:
            return all(torch.equal(v.cpu(), want[k]) for k, v in m.state.model.state_dict().items())

        # Tent from the orbax checkpoint cli.train wrote
        results, run_dir, wall, counts = run(adapt, "adapt", "tta=tent", "tta.steps=1", "tta.report_no_adapt=true",
                                             f"training.resume={best_orbax}")
        with open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8") as f:
            written = json.load(f)
        if written != json.loads(json.dumps(results)) or set(written) != {"no_adapt", "adapted"}:
            raise AssertionError(f"tta_metrics.json: {sorted(written)}")
        for mode, metrics in written.items():
            if "gtvt_dc" not in metrics or "dom/CHUS/avg_dc" not in metrics or "gtvt_hd95" not in metrics:
                raise AssertionError(f"{mode}: keys {sorted(metrics)}")
            for k, v in metrics.items():
                bounded = k.endswith(("_dc", "_iou", "_nsd")) or k.split("/")[-1] in ("avg_dc", "avg_iou")
                if not np.isfinite(v) or v < 0 or (bounded and v > 1):
                    raise AssertionError(f"{mode}: {k} = {v}")
        test_batches = len(managers[-1].test_loader)
        out["adapt"] = {"wall_s": wall, "launches": counts, "test_batches": test_batches,
                        "model_restored": restored(managers[-1], source_orbax),
                        "checkpoint": os.path.relpath(best_orbax, root) + ".orbax",
                        "metrics": {mode: {k: v for k, v in m.items() if "/" not in k or k.endswith("avg_dc")}
                                    for mode, m in written.items()}}
        if not out["adapt"]["model_restored"]:
            raise AssertionError("the adapt CLI left the model adapted")

        rows, run_dir, wall, counts = run(predict, "predict", "tta=tent", "tta.episodic=false",
                                          "predict.save_prob=true", f"training.resume={best}")
        pred_dir = os.path.join(run_dir, "predictions")
        with open(os.path.join(pred_dir, "predictions.csv"), newline="", encoding="utf-8") as f:
            written = list(csv.DictReader(f))
        threshold = managers[-1].config.evaluation.seg.threshold
        checked = []
        for row in written:
            mask = nifti.load(os.path.join(pred_dir, row["files"]))
            prob = nifti.load(os.path.join(pred_dir, row["prob_file"]))
            affine, shape_xyz = nifti.peek_canonical_geometry(cases[row["case_id"]]["ct_proc"])
            a, p = np.asarray(mask.dataobj), np.asarray(prob.dataobj)
            checked.append(row["status"] == "ok" and a.dtype == np.uint8 and a.shape == tuple(shape_xyz)
                           and np.array_equal(mask.affine, affine) and np.array_equal(a, (p >= threshold))
                           and int(a.sum()) == int(row["voxels_gtvt"]))
        if len(written) != centers["CHUS"] or len(rows) != len(written) or not all(checked):
            raise AssertionError(f"predict: {len(written)} rows, checks {checked}")
        out["predict"] = {"wall_s": wall, "launches": counts, "cases": len(written),
                          "test_batches": len(managers[-1].test_loader), "model_restored": restored(managers[-1]),
                          "voxels": [int(r["voxels_gtvt"]) for r in written]}
        if not out["predict"]["model_restored"]:
            raise AssertionError("the predict CLI left the model adapted")
    finally:
        ExperimentManager.setup_optimizer, ExperimentManager.setup_trainer = orig_setup_optimizer, orig_setup_trainer
        managers.clear()
    out["decodes"] = nifti.decode_counts.snapshot()
    if out["decodes"]["python"] != 0 or out["decodes"]["native"] == 0:
        raise AssertionError(f"NIfTI decodes by path: {out['decodes']} (the native path only expected)")
    return out


# phase 15: every stock TTA config (configs/tta/*.yaml, "none" apart), SAR
# and EATA with their entropy gates open, and the Tent variants of the
# extras, each through TTAEngine.evaluate
TTA_RUNS = [(name, [f"tta={name}"]) for name in
            ("tent", "continual", "pl", "eata", "eata_gate", "sar", "cotta", "cotta_restore", "memo", "norm")] + [
    # phase 11's weights are so uncertain that the stock 0.4 ln 2 entropy
    # gates of SAR and EATA pass no sample: these two let every sample in
    ("sar_all_reliable", ["tta=sar", "tta.margin_ratio=1.0"]),
    ("eata_all_reliable", ["tta=eata", "tta.reliability.margin_ratio=1.0"]),
    # SAR's recovery floor above these weights' entropy (0.91 H_max): em
    # falls below it at every step, so each step snaps back to source
    ("sar_recovery_reset", ["tta=sar", "tta.margin_ratio=1.0", "tta.reset_floor_ratio=0.95"]),
    ("tent_window", ["tta=tent", "tta.window.enabled=true"]),
    # the stock floor (0.3 of the first step's entropy) is out of reach of
    # two steps here; 0.999 freezes a batch whose second step lowers it
    ("tent_consistency_early_stop_dropout", ["tta=tent", "tta.steps=2", "tta.loss=entropy+consistency",
                                             "tta.early_stop.enabled=true", "tta.early_stop.entropy_floor_ratio=0.999",
                                             "tta.modality_dropout.enabled=true"]),
    # a floor above the first step's entropy freezes every batch at its
    # first step: the second is the frozen tail's no-grad forward
    ("tent_early_stop_frozen_tail", ["tta=tent", "tta.steps=2", "tta.early_stop.enabled=true",
                                     "tta.early_stop.entropy_floor_ratio=1.5"]),
]


def tta_overrides(*extra: str) -> list:
    """The HECKTOR21 recipe of configs/ with surface metrics on, then ``extra``."""
    return ["task=hecktor21", "dataset=hecktor21", "model=unet", "evaluation.surface.enable=true",
            f"evaluation.surface.nsd_tol={NSD_TOL}", *extra]


def active_steps(adapter, trace) -> int:
    """How many of a batch's steps updated the params: all, unless Tent's
    early stop froze the batch at the first step below its floor (relative to
    the first step's entropy in ``TTAEngine.evaluate``, which passes none)."""
    if not getattr(adapter, "early_stop", False):
        return len(trace)
    floor = adapter.early_stop_ratio * trace[0]
    for i, e in enumerate(trace):
        if not e >= floor:
            return i
    return len(trace)


def sar_resets(adapter, traces, n_classes: int = 2) -> list:
    """SAR's recovery resets per batch, derived from the step monitors in
    ``traces``: the EMA ``em`` (NaN-started, carried across batches unless
    episodic) snaps back to source, and to NaN, when it falls below
    ``reset_floor_ratio * H_max``."""
    h_max = math.log(2.0 if adapter.sigmoid_mode else n_classes)
    em, out = float("nan"), []
    for trace in traces:
        if adapter.episodic:
            em = float("nan")
        n = 0
        for mon in trace:
            em = mon if em != em else adapter.reset_alpha * em + (1.0 - adapter.reset_alpha) * mon
            if em < adapter.reset_floor_ratio * h_max:
                em, n = float("nan"), n + 1
        out.append(n)
    return out


def expected_tta_launches(adapter, n_batches: int, traces, per_forward: int = 18, recompute: int = 0) -> tuple:
    """(forward, backward) norm kernel launches of ``TTAEngine.evaluate``
    over ``n_batches`` batches whose entropy traces are ``traces``, derived from the
    reference's step structure: each batch's evaluation forward, plus per
    adaptation step (each backward of a Tent-engine step also runs the
    forward of the ``recompute`` rematerialized norms again)
      - Tent engine (tent, pl, eata): one forward and one backward, two of
        each with ``+consistency`` (a frozen early-stop step forwards without
        a backward); the Fisher estimate one of each on its first batches;
      - sar: two forwards and two backwards (the SAM ascent and descent);
      - cotta: ``n_views`` teacher forwards and the student's forward and
        backward;
      - memo: ``n_views`` forwards for the marginal, then one forward and one
        backward per view;
      - norm (no batch statistics): nothing."""
    f = per_forward
    fwd = bwd = 0
    for i in range(n_batches):
        trace = traces[i] if i < len(traces) else []
        fwd += f
        method = getattr(adapter, "method", "none")
        if method in ("none", "norm"):
            continue
        k = adapter.steps
        if method == "sar":
            fwd, bwd = fwd + 2 * f * k, bwd + 2 * f * k
        elif method == "cotta":
            fwd, bwd = fwd + (adapter.n_views + 1) * f * k, bwd + f * k
        elif method == "memo":
            fwd, bwd = fwd + 2 * adapter.n_views * f * k, bwd + adapter.n_views * f * k
        else:
            per = 2 if adapter.loss_mode.endswith("+consistency") else 1
            active = active_steps(adapter, trace)
            fwd, bwd = fwd + per * (f * k + recompute * active), bwd + per * f * active
            if adapter.fisher_enabled and i < adapter.fisher_batches:
                fwd, bwd = fwd + f + recompute, bwd + f
    return fwd, bwd


# phase 15's streams through cli.adapt on phase 14's fixture: the test cases
# of two centres in order; the forwards and backwards of one adapted batch
# of each stock config as it serves there (tent.yaml: one step and a
# post-update forward; eata_gate.yaml: four steps, inline predictions)
STREAM_ORDER = ("CHUS", "CHGJ")
STREAM_RUNS = {
    "stream_tent": (["tta=tent", "tta.episodic=false", "tta.stream.policy=reset_on_domain_change",
                     "tta.stream.guard=true"], (2, 1)),
    "stream_eata_gate": (["tta=eata_gate", "tta.stream.policy=continual", "tta.stream.guard=true",
                          "tta.stream.gate.enabled=true", "tta.stream.periodic_reanchor_every=1"], (4, 4)),
}


def gate_probe(device, manifest: str, best: str, root: str, args, extra=()) -> list:
    """The plain (gate) entropy of each stream batch at the source model, as
    the gate's forward path computes it; not a CLI call, not counted."""
    import torch

    from multimodal_tta_tpu_torch.cli import CONFIG_DIR
    from multimodal_tta_tpu_torch.cli.adapt import load_serving_state
    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.utils.logger import get_logger

    cfg = compose(CONFIG_DIR, "config", cli_overrides(manifest, os.path.join(root, "probe"), *args,
                                                      f"training.resume={best}", *extra))
    m = ExperimentManager(cfg, device=torch.device(device))
    m.setup_model()
    m.setup_test_data()
    m.setup_optimizer()
    load_serving_state(m, cfg, get_logger(), "probing")
    builder = m._builder
    engine = TTAEngine(cfg, device_transform=builder.build_transform("test").device_spec(), device=torch.device(device))
    fp = engine.adapter.make_forward_predict_fn(m.state.model, float(cfg.evaluation.seg.threshold))
    return [fp(m.state.model, torch.as_tensor(b["image"]), int(b.get("_n_valid", len(b["image"]))))[2]
            for dom in STREAM_ORDER for b in builder.get_loader("test", target_center=dom)]


def stream_phase(device, manifest: str, best: str, root: str, *, extra=(), reset_counts=lambda: None,
                 read_counts=lambda: {}, per_forward: int = 18) -> dict:
    """Phase 15's streams: ``cli.adapt`` with ``tta.stream.enabled=true`` over
    the test cases of ``STREAM_ORDER`` (``tta.stream.domain_order``), from
    ``best``: Tent continual with ``reset_on_domain_change`` and the guard
    (a re-anchor at the centre change at least), then ``eata_gate`` with the
    entropy gate on. The gate takes an absolute ``gate.threshold``, the
    midpoint of the stream's lowest and highest gate entropy at the source
    (``gate_probe``), so that the first batch above it escalates; the
    re-anchor after every adapted batch drops back to forward mode.

    Checks what holds on any device: the ``tta_metrics.json`` schema, a
    re-anchor, the gate's escalation and drop back, the model restored.
    Per run: the metrics, the launch counts, the wall time, and the launches
    the run must make (``STREAM_RUNS`` per adapted batch and one forward per
    forward-mode probe, ``per_forward`` norm calls each)."""
    import torch

    from multimodal_tta_tpu_torch.cli import adapt

    dev = torch.device(device)
    order = "[" + ",".join(STREAM_ORDER) + "]"
    out = {}
    for name, (args, per_adapt) in STREAM_RUNS.items():
        args = list(args) + ["tta.stream.enabled=true", f"tta.stream.domain_order={order}"]
        if "tta.stream.gate.enabled=true" in args:
            gates = gate_probe(device, manifest, best, root, args, extra)
            args.append(f"tta.stream.gate.threshold={0.5 * (min(gates) + max(gates))!r}")
        run_dir = os.path.join(root, "runs", name)
        reset_counts()
        t0 = time.perf_counter()
        try:
            results = adapt.main(cli_overrides(manifest, run_dir, *args, f"training.resume={best}", *extra),
                                 device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8") as f:
            written = json.load(f)
        m = written["adapted"]
        if written != json.loads(json.dumps(results)) or set(written) != {"adapted"}:
            raise AssertionError(f"{name}: tta_metrics.json {sorted(written)}")
        doms = [p["domain"] for p in m["positions"]]
        if sorted(set(doms)) != sorted(STREAM_ORDER) or doms != sorted(doms, key=list(STREAM_ORDER).index):
            raise AssertionError(f"{name}: stream order {doms}")
        n = len(m["positions"])
        if "gate/forward_batches" in m:
            probes = m["gate/forward_batches"] + len(m["gate/escalations"])
            adapted = m["gate/adapt_batches"]
            if not m["gate/escalations"] or m["reanchors"] < 1:
                # each re-anchor drops the gate back to forward mode
                raise AssertionError(f"{name}: the gate must escalate and drop back: {m['gate/escalations']}, "
                                     f"{m['reanchors']} re-anchors")
            out[name] = {"gate_threshold": float(args[-1].split("=")[1]), "gate_probe": gates}
        else:
            probes, adapted = 0, n
            if m["reanchors"] < 1:
                raise AssertionError(f"{name}: no re-anchor at the centre change")
        want = {"forward": per_forward * (probes + per_adapt[0] * adapted),
                "backward": per_forward * per_adapt[1] * adapted}
        out.setdefault(name, {}).update(metrics=m, launches=counts, want=want, wall_s=wall, batches=n)
    return out


def tta_phase(device, model, batches, *, runs=TTA_RUNS, extra=(), reset_counts=lambda: None,
              read_counts=lambda: {}, base=tta_overrides, device_transform=None, region: str = "gtvt") -> dict:
    """Phase 15: every TTA method of the port through ``TTAEngine.evaluate``
    on ``model`` over ``batches`` (dicts of image, label, domain), with the
    stock configs of configs/tta/ composed into the HECKTOR21 recipe
    (phase 16: ``base`` composes the BraTS recipe, ``device_transform`` is
    its transform, ``region`` a region of its report).

    Checks what holds on any device: every metric finite, the model bitwise
    its source after each run, what each method carries reset. Per run it
    returns the metrics, the kernel launch counts (``read_counts`` after
    ``reset_counts`` just before the run), the adapter, each batch's entropy
    trace, its writes of the source values into the adapted params inside
    the adaptation (``source_copies``: SAR's recovery resets, plus the
    episodic reset) and wall time (a synchronise after each evaluated
    batch)."""
    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    source = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    for tag, overrides in runs:
        cfg = compose(os.path.join(REPO, "configs"), "config", base(*overrides, *extra))
        engine = TTAEngine(cfg, device_transform=device_transform or DEVICE_TRANSFORM, device=dev)
        adapter, strategy = engine.adapter, engine.strategy
        traces, marks, copies = [], [], []
        if hasattr(adapter, "_adapt"):
            adapt, copy_source, n_copies = adapter._adapt, adapter._copy_source, [0]

            def counting(_copy=copy_source, _n=n_copies):
                _n[0] += 1
                _copy()

            def recording(*args, _adapt=adapt, _ad=adapter, _n=n_copies, **kwargs):
                before = _n[0]
                result = _adapt(*args, **kwargs)
                traces.append(_ad._last_ents.tolist())
                copies.append(_n[0] - before)
                return result

            adapter._copy_source, adapter._adapt = counting, recording
        eval_step = strategy._eval_step

        def timed(*args, _step=eval_step, **kwargs):
            result = _step(*args, **kwargs)
            sync()
            marks.append(time.perf_counter())
            return result

        strategy._eval_step = timed
        sync()
        reset_counts()
        t0 = time.perf_counter()
        metrics = engine.evaluate(model, batches)
        sync()
        counts = read_counts()
        wall = time.perf_counter() - t0
        ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad or f"{region}_hd95" not in metrics:
            raise AssertionError(f"{tag}: metrics not finite or incomplete: {bad or sorted(metrics)}")
        changed = [k for k, v in model.state_dict().items() if not torch.equal(v, source[k])]
        if changed:
            raise AssertionError(f"{tag}: evaluate left {changed[:3]} changed")
        if getattr(adapter, "method", "") == "sar" and not bool(torch.isnan(adapter._em)):
            raise AssertionError(f"{tag}: SAR's entropy EMA was not reset")
        if getattr(adapter, "method", "") == "cotta" and not all(
                torch.equal(a, b) for a, b in zip(adapter._teacher, adapter._source)):
            raise AssertionError(f"{tag}: CoTTA's teacher was not reset")
        out[tag] = {"metrics": metrics, "launches": counts, "traces": traces, "source_copies": copies,
                    "ms_per_batch": ms, "wall_s": wall,
                    "adapter": adapter, "batches": len(batches), "config": cfg.tta.to_container(),
                    "model_unchanged": not changed}
    return out


# ---- phase 16: the BraTS recipe of train_brats.sh ---------------------------
BRATS_SHAPE = (160, 192, 160)  # [D,H,W]: configs/dataset/brats.yaml's expected_shape, as the builder yields it
BRATS_BATCH = 2  # train_brats.sh: BS and EVAL_BS
BRATS_NORMS = 52  # norm calls of one mid-fusion forward: 40 in the encoders, 4 in the fusion, 8 in the decoder
BRATS_PARAMS = (208, 98)  # the mid-fusion model's parameter tensors and norm affines
BRATS_TRAIN_VOLUMES, BRATS_VAL_VOLUMES, BRATS_TTA_BATCHES, BRATS_SERVING_STEPS = 4, 2, 2, 3
BRATS_THRESHOLD = 0.5  # configs/_global_patches/brats.yaml evaluation.seg.threshold
BRATS_DOMAINS = ("brats24_ssa", "brats24_ped")  # configs/dataset/brats.yaml's two test sources
# the runs of TTAEngine.evaluate: no adaptation, Tent episodic (post-update
# predictions) and continual (inline), and BASELINE.json config #3: Tent
# with missing-modality dropout
BRATS_TTA_RUNS = [
    ("none", ["tta=none"]),
    ("tent_episodic_post", ["tta=tent", "tta.episodic=true", "tta.predict=post"]),
    ("tent_continual_inline", ["tta=tent", "tta.episodic=false", "tta.predict=inline"]),
    ("tent_modality_dropout", ["tta=tent", "tta.modality_dropout.enabled=true"]),
]
# the CLIs' BraTS NIfTI fixture, (X,Y,Z) on disk: scripts/validate_tta_brats.py's shape
BRATS_CLI_SHAPE = (96, 96, 64)
BRATS_CLI_SOURCES = {"glipre": {"profile": "gli", "cases": {"train": 4, "test": 2}},
                     "ssa": {"profile": "ssa", "cases": {"test": 2}},
                     "ped": {"profile": "ped", "cases": {"test": 2}}}


def brats_overrides(*extra: str) -> list:
    """train_brats.sh's recipe (task, dataset and model, training=default,
    batch 2, eval batch 2, adam at lr 1e-4, remat) with training-time
    modality dropout on the device (configs/_global_patches/brats.yaml's
    switch), surface metrics on, seed 0, then ``extra``."""
    return ["task=brats", "dataset=brats", "model=unet_multimodal_midfusion", "training=default",
            f"training.batch_size={BRATS_BATCH}", f"training.eval_batch_size={BRATS_BATCH}",
            "training.optimizer=adam", "training.optimizers.adam.lr=1e-4", "training.remat=true",
            "training.data.transforms.on_device=true", "training.data.transforms.modality_dropout.enabled=true",
            "evaluation.surface.enable=true", "task.seed=0", *extra]


def check_brats_metrics(tag: str, metrics: dict) -> None:
    """Every value finite and non-negative; Dice, IoU and NSD at most 1."""
    for k, v in metrics.items():
        base = k.rsplit("/", 1)[-1]
        bounded = base.endswith(("_dc", "_iou", "_nsd")) or base in ("avg_dc", "avg_iou", "miou", "jc")
        if not (math.isfinite(float(v)) and v >= 0 and (not bounded or v <= 1 + 1e-6)):
            raise AssertionError(f"{tag}: {k} = {v}")
    if "et_hd95" not in metrics:
        raise AssertionError(f"{tag}: keys {sorted(metrics)}")


def _counted(counts: dict, want: dict) -> bool:
    """``counts`` equal ``want`` on every key the counter has (on the card:
    norm forward and backward, min-plus, plain backward; a missing want is
    0), and the counter has the norm keys."""
    return {"forward", "backward"} <= set(counts) and all(counts[k] == want.get(k, 0) for k in counts)


def brats_train_and_serve(device, root: str, *, shape=BRATS_SHAPE, extra=(), reset_counts=lambda: None,
                          read_counts=lambda: {}, per_forward: int = BRATS_NORMS) -> dict:
    """Phase 16, training and serving: the train_brats.sh recipe through
    ``ExperimentManager`` (2 epochs over ``BRATS_TRAIN_VOLUMES`` synthetic
    volumes of ``shape`` from ``data/synthetic.py`` handed in as arrays,
    validation with surface metrics each epoch), then its trained weights
    through ``TTAEngine.evaluate`` (``BRATS_TTA_RUNS`` over two domains), one
    Tent step alone (its gradients and peak memory) and the Tent serving
    step (``make_adapt_predict_fn``), post and inline.

    Checks what holds on any device: finite losses; every tensor moved but
    the domain head's two (no loss reaches it, as in the reference); the
    launches of every step, validation batch and run exactly as remat and the
    step structure derive them (``read_counts`` after ``reset_counts``;
    with remat on, each backward runs the forward of all ``per_forward``
    norms again); each validation batch's EDT bitwise its plain version;
    finite metrics in range; every norm tensor reached by Tent's gradient;
    the model bitwise its trained weights after each run. The model,
    its trained state and the numbers come back for the caller."""
    import shutil
    import statistics

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.data import HostLoader
    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.registry import get_dataset_builder
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def base(*o):
        return brats_overrides(*o, *extra)

    shutil.rmtree(root, ignore_errors=True)
    configs = os.path.join(REPO, "configs")
    out: dict = {}
    t0 = time.perf_counter()
    train_set = brats_volumes(BRATS_TRAIN_VOLUMES, shape, seed=41)
    val_set = brats_volumes(BRATS_VAL_VOLUMES, shape, seed=42)
    vols = brats_volumes(BRATS_BATCH * BRATS_TTA_BATCHES, shape, seed=43, domains=BRATS_DOMAINS)
    out["data_s"] = time.perf_counter() - t0

    run_dir = os.path.join(root, "train")
    cfg = compose(configs, "config", base("training.epochs=2", "training.model_save_start=0",
                                          "training.model_save_freq=1", "training.eval_test.every_n_epochs=1",
                                          f"task.save_dir={run_dir}", f"hydra.run.dir={run_dir}"))
    builder = get_dataset_builder("brats")(cfg)
    m = ExperimentManager(cfg, device=dev)
    model = m.setup_model()
    m.setup_optimizer()
    m.setup_scheduler()
    m.train_loader = HostLoader(train_set, batch_size=BRATS_BATCH, shuffle=True, drop_last=True, num_workers=2,
                                seed=0)
    m.val_loader = HostLoader(val_set, batch_size=BRATS_BATCH, num_workers=2)
    m.device_transform = builder.build_transform("train").device_spec()
    m.setup_trainer()
    recompute = per_forward if model.remat else 0

    class StepRecorder(HookBase):
        def __init__(self):
            self.launches, self.losses, self.ms = [], [], []

        def before_train_step(self):
            sync()
            self._at, self._t = read_counts(), time.perf_counter()

        def after_train_step(self):
            sync()
            self.ms.append((time.perf_counter() - self._t) * 1e3)
            got = read_counts()
            self.launches.append({k: got[k] - self._at[k] for k in got})
            self.losses.append(self.trainer._pending_loss)

    rec = StepRecorder()
    m.trainer.register_hooks([rec])
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    val_edt = []

    def recording_edt(pts, spacing, *, sqrt=False):
        got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        val_edt.append((pts.clone(), spacing, sqrt, got.clone()))
        return got

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    surface_module.squared_edt_volumes = recording_edt
    reset_counts()
    t0 = time.perf_counter()
    try:
        history = m.train(2)
        sync()
    finally:
        surface_module.squared_edt_volumes = squared_edt_volumes
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    losses = [float(v) for v in rec.losses]
    frozen = sorted(n for n, p in model.named_parameters() if torch.equal(p, params0[n]))
    n_steps, n_val = len(losses), 2 * len(m.val_loader)
    step_want = {"forward": per_forward + recompute, "backward": per_forward}
    run_want = {"forward": n_steps * (per_forward + recompute) + n_val * per_forward,
                "backward": n_steps * per_forward, "minplus": n_val}
    edt = []
    for pts, spacing, root_, got in val_edt:
        edt.append({"shape": list(pts.shape), "bitwise_plain": torch.equal(got, squared_edt_volumes_plain(
            pts, spacing, sqrt=root_)), "with_points": int(pts.flatten(1).any(1).sum())})
    del val_edt
    out["train"] = {"wall_s": wall, "losses": losses, "step_ms": rec.ms, "step_launches": rec.launches,
                    "launches": counts, "want": run_want, "step_want": step_want, "frozen": frozen,
                    "params": (len(params0), sum(norm_param_mask(model).values())), "peak_gib": peak / 2**30,
                    "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]],
                    "edt": edt, "steps": n_steps, "val_batches": n_val}
    if n_steps != 2 * (BRATS_TRAIN_VOLUMES // BRATS_BATCH) or not all(np.isfinite(losses)):
        raise AssertionError(f"brats training: {n_steps} steps, losses {losses}")
    if frozen != ["domain_classifier.bias", "domain_classifier.weight"]:
        raise AssertionError(f"brats training left {frozen} unmoved (the domain head's two expected)")
    if not all(_counted(s, step_want) for s in rec.launches) or not _counted(counts, run_want):
        raise AssertionError(f"brats training launches {rec.launches} / {counts}, derived {step_want} / {run_want}")
    if len(edt) != n_val or not all(e["bitwise_plain"] and e["shape"][0] == 2 * 3 * BRATS_BATCH for e in edt):
        raise AssertionError(f"brats validation EDT: {edt}")
    for ev in history["eval_history"]:
        check_brats_metrics("brats validation", ev)

    # warm steps on device-resident batches: ms a step, volumes/s, peak memory
    trainer = m.trainer
    dev_batches = [{"image": torch.from_numpy(np.stack([s["image"] for s in train_set[k:k + BRATS_BATCH]])).to(dev),
                    "label": torch.from_numpy(np.stack([s["label"] for s in train_set[k:k + BRATS_BATCH]])).to(dev),
                    "_n_valid": BRATS_BATCH} for k in (0, BRATS_BATCH)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    warm = []
    for i in range(4):
        sync()
        t0 = time.perf_counter()
        trainer.run_step(dev_batches[i % 2])
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    trainer.flush_step_metrics()
    med = statistics.median(warm[1:])
    out["train"].update(warm_step_ms=warm, median_step_ms=med, volumes_per_s=BRATS_BATCH * 1e3 / med,
                        warm_peak_gib=(torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30)
    del dev_batches, trainer
    m.trainer.state.optimizer.zero_grad(set_to_none=True)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    shutil.rmtree(run_dir, ignore_errors=True)

    # ---- serving: TTAEngine.evaluate on the trained weights ----------------
    batches = [{"image": np.stack([v["image"] for v in vols[k:k + BRATS_BATCH]]),
                "label": np.stack([v["label"] for v in vols[k:k + BRATS_BATCH]]),
                "domain": [v["domain"] for v in vols[k:k + BRATS_BATCH]]} for k in range(0, len(vols), BRATS_BATCH)]
    spec = builder.build_transform("test").device_spec()
    tta = tta_phase(dev, model, batches, runs=BRATS_TTA_RUNS, base=base, device_transform=spec, region="et",
                    reset_counts=reset_counts, read_counts=read_counts)
    out["tta"] = {}
    for tag, r in tta.items():
        f, b = expected_tta_launches(r["adapter"], r["batches"], r["traces"], per_forward, recompute)
        want = {"forward": f, "backward": b, "minplus": r["batches"]}
        check_brats_metrics(tag, r["metrics"])
        for dom in BRATS_DOMAINS:
            if f"dom/{dom}/avg_dc" not in r["metrics"]:
                raise AssertionError(f"{tag}: no report of {dom}")
        if not _counted(r["launches"], want) or not r["model_unchanged"]:
            raise AssertionError(f"{tag}: launches {r['launches']}, derived {want}")
        out["tta"][tag] = {"ms_per_batch": r["ms_per_batch"], "launches": r["launches"], "want": want,
                           "traces": r["traces"], "metrics": {k: v for k, v in r["metrics"].items() if "/" not in k}}
    del tta

    # one Tent step alone: every norm tensor's gradient, the step's peak memory
    x0 = torch.from_numpy(batches[0]["image"]).to(dev)
    cfg_t = compose(configs, "config", base("tta=tent"))
    ad = TentAdapter(cfg_t.tta, config=cfg_t, device_transform=spec, device=dev)
    fn = ad.make_adapt_fn(model)
    fn(model, x0, BRATS_BATCH)  # first call: cuDNN set-up and the allocator's pools
    ad.restore()
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    reset_counts()
    t0 = time.perf_counter()
    fn(model, x0, BRATS_BATCH)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    names = [n for n, v in norm_param_mask(model).items() if v]
    params = dict(model.named_parameters())
    reached = [n for n in names if params[n].grad is not None and bool(params[n].grad.abs().max() > 0)
               and bool(torch.isfinite(params[n].grad).all())]
    ad.restore()
    want = {"forward": per_forward + recompute, "backward": per_forward}
    out["tent_step"] = {"ms": step_ms, "launches": counts, "want": want, "grad_reached": len(reached),
                        "norm_tensors": len(names), "held_gib": held / 2**30, "peak_gib": peak / 2**30}
    if len(reached) != len(names) or not _counted(counts, want):
        raise AssertionError(f"brats Tent step: gradient in {len(reached)} of {len(names)} norm tensors, "
                             f"launches {counts}, derived {want}")

    # the Tent serving step: inline (continual) and post (episodic) predictions
    out["serving"] = {}
    for proto, predict, episodic in (("online", "inline", False), ("strict", "post", True)):
        cfg_s = compose(configs, "config", base("tta=tent", f"tta.episodic={str(episodic).lower()}",
                                                f"tta.predict={predict}"))
        ad = TentAdapter(cfg_s.tta, config=cfg_s, device_transform=spec, device=dev)
        step = ad.make_adapt_predict_fn(model, threshold=BRATS_THRESHOLD, predict_mode=predict)
        times = []
        reset_counts()
        for i in range(BRATS_SERVING_STEPS):
            sync()
            t0 = time.perf_counter()
            _, pred = step(model, torch.from_numpy(batches[i % len(batches)]["image"]).to(dev), BRATS_BATCH)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        ad.restore()
        per_step = per_forward * (2 if predict == "post" else 1) + recompute
        want = {"forward": BRATS_SERVING_STEPS * per_step, "backward": BRATS_SERVING_STEPS * per_forward}
        out["serving"][proto] = {"ms_per_step": times, "launches": counts, "want": want,
                                 "volumes_per_s": BRATS_BATCH * 1e3 / statistics.median(times[1:])}
        if pred.dtype != torch.uint8 or tuple(pred.shape) != (BRATS_BATCH,) + tuple(shape) + (3,):
            raise AssertionError(f"brats serving {proto}: predictions {pred.dtype} {tuple(pred.shape)}")
        if not _counted(counts, want):
            raise AssertionError(f"brats serving {proto}: launches {counts}, derived {want}")
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, trained[k])]
    if changed:
        raise AssertionError(f"brats serving left {changed[:3]} changed")
    out["model"], out["trained"], out["batches"] = model, trained, batches
    return out


def brats_cli(device, root: str, *, shape=BRATS_CLI_SHAPE, sources=None, extra=(), reset_counts=lambda: None,
              read_counts=lambda: {}, per_forward: int = BRATS_NORMS) -> dict:
    """Phase 16, the CLIs: ``cli.train`` and then ``cli.adapt`` (Tent,
    surface metrics, the no-adapt report) of the train_brats.sh recipe at
    full width on a BraTS NIfTI fixture written by ``make_brats_fixture``
    (glipre train/test, ssa test, ped test at ``shape`` (X,Y,Z)). Checks the
    run directory, finite losses, the report's schema, ranges and per-domain
    keys (the two test sources), and each call's launches exactly as remat
    and the step structure derive them."""
    import shutil

    import numpy as np

    from multimodal_tta_tpu_torch.cli import adapt, train
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.data.synthetic import make_brats_fixture

    shutil.rmtree(root, ignore_errors=True)
    out: dict = {}
    t0 = time.perf_counter()
    csvs = make_brats_fixture(os.path.join(root, "data"), sources=sources or BRATS_CLI_SOURCES, shape=tuple(shape),
                              seed=5, n_lesions=(1, 2))
    out["fixture_s"] = time.perf_counter() - t0
    x, y, z = shape
    args = [f"dataset.sources.{i}.csv_path={csvs[s]}" for i, s in enumerate(("glipre", "ssa", "ped"))] + [
        f"dataset.expected_shape=[{x},{y},{z}]", f"training.data.transforms.image_size=[{z},{y},{x}]",
        "training.epochs=1", "training.model_save_start=0", "training.model_save_freq=1",
        "training.eval_test.every_n_epochs=1", *extra]
    managers = []
    orig = ExperimentManager.setup_optimizer

    def setup_optimizer(self):  # each CLI calls it once: the manager it built
        managers.append(self)
        return orig(self)

    def run(cli, name: str, *more: str):
        run_dir = os.path.join(root, "runs", name)
        reset_counts()
        t1 = time.perf_counter()
        try:
            result = cli.main(brats_overrides(*args, *more, f"task.save_dir={os.path.dirname(run_dir)}",
                                              f"hydra.run.dir={run_dir}"), device=device)
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        return result, run_dir, time.perf_counter() - t1, read_counts()

    ExperimentManager.setup_optimizer = setup_optimizer
    try:
        history, run_dir, wall, counts = run(train, "train")
        mt = managers[-1]
        recompute = per_forward if mt.model.remat else 0
        epochs = len(history["train_history"])
        # each epoch validates, and tests too (configs/_global_patches/brats.yaml: do_test)
        val = epochs * (len(mt.val_loader) + len(mt.test_loader))
        steps = epochs * len(mt.train_loader)
        want = {"forward": steps * (per_forward + recompute) + val * per_forward, "backward": steps * per_forward,
                "minplus": val}
        losses = [h["loss"] for h in history["train_history"]]
        out["train"] = {"wall_s": wall, "launches": counts, "want": want, "steps": steps, "val_batches": val,
                        "losses": losses, "val": [{k: v for k, v in ev.items() if "/" not in k}
                                                  for ev in history["eval_history"]]}
        best = os.path.join(run_dir, "checkpoints", "best_model")
        if not os.path.isfile(best + ".msgpack") or not all(np.isfinite(losses)) or not _counted(counts, want):
            raise AssertionError(f"brats cli.train: {out['train']}, checkpoints "
                                 f"{sorted(os.listdir(os.path.dirname(best)))}")

        results, run_dir, wall, counts = run(adapt, "adapt", "tta=tent", "tta.report_no_adapt=true",
                                             f"training.resume={best}")
        with open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8") as f:
            written = json.load(f)
        b = len(managers[-1].test_loader)
        want = {"forward": b * (3 * per_forward + recompute), "backward": b * per_forward, "minplus": 2 * b}
        out["adapt"] = {"wall_s": wall, "launches": counts, "want": want, "test_batches": b,
                        "metrics": {mode: {k: v for k, v in r.items() if "/" not in k or k.endswith("avg_dc")}
                                    for mode, r in written.items()}}
        if written != json.loads(json.dumps(results)) or set(written) != {"no_adapt", "adapted"}:
            raise AssertionError(f"brats tta_metrics.json: {sorted(written)}")
        for mode, r in written.items():
            check_brats_metrics(f"brats cli.adapt {mode}", r)
            doms = sorted({k.split("/")[1] for k in r if k.startswith("dom/")})
            if doms != sorted(BRATS_DOMAINS):
                raise AssertionError(f"brats cli.adapt {mode}: domains {doms}")
        if not _counted(counts, want):
            raise AssertionError(f"brats cli.adapt: launches {counts}, derived {want}")
    finally:
        ExperimentManager.setup_optimizer = orig
        managers.clear()
    shutil.rmtree(root, ignore_errors=True)
    return out


def brats_other_models(device, shape=BRATS_SHAPE, *, channels=(32, 64, 128, 256, 512), init_filters: int = 16,
                       reset_counts=lambda: None, read_counts=lambda: {}) -> dict:
    """Phase 16, the other models of the slice at full width, bf16, on one
    volume [1, *shape, 4] (4 modalities, 3 regions): late fusion, UNet3D-WS
    and SegResNet. Each: one forward through the norm kernel and again
    through the plain norm (logits relative L2), its norm calls counted,
    and one Tent step (every norm tensor's gradient, its launches). The
    caller holds the numbers against their limits."""
    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
    from multimodal_tta_tpu_torch.models import MultimodalUNetLateFusion, SegResNet, UNet3DWS
    from multimodal_tta_tpu_torch.models.layers import set_plain_norm
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = torch.from_numpy(brats_volumes(1, tuple(shape), seed=44)[0]["image"][None]).to(dev)
    cfg = ConfigNode({"task": {"seed": 0}, "training": {"criterion": {"sigmoid": True}},
                      "tta": {"method": "tent", "steps": 1, "lr": 1e-3, "optimizer": "sgd", "momentum": 0.9,
                              "update": "norm", "episodic": True}})
    unet = dict(num_classes=3, channels=tuple(channels), dtype=torch.bfloat16, device=dev, seed=0)
    builders = {"unet_multimodal_late": lambda: MultimodalUNetLateFusion(num_modalities=4, **unet),
                "unet_ws": lambda: UNet3DWS(in_channels=4, **unet),
                "segresnet": lambda: SegResNet(in_channels=4, num_classes=3, init_filters=init_filters,
                                               dtype=torch.bfloat16, device=dev, seed=0)}
    out = {}
    for name, build in builders.items():
        model = build()
        with torch.no_grad():
            sync()
            reset_counts()
            t0 = time.perf_counter()
            logits = model(x)
            sync()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            per_forward = read_counts()
            set_plain_norm(model, True)
            plain = model(x)
            set_plain_norm(model, False)
        rel = float((logits - plain).norm() / plain.norm())
        finite = bool(torch.isfinite(logits).all())
        ad = TentAdapter(cfg.tta, config=cfg, device_transform={"normalize": False}, device=dev)
        fn = ad.make_adapt_fn(model)
        reset_counts()
        t0 = time.perf_counter()
        fn(model, x, 1)
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        step = read_counts()
        names = [n for n, v in norm_param_mask(model).items() if v]
        params = dict(model.named_parameters())
        reached = [n for n in names if params[n].grad is not None and bool(params[n].grad.abs().max() > 0)
                   and bool(torch.isfinite(params[n].grad).all())]
        ad.restore()
        out[name] = {"params": len(params), "norm_tensors": len(names), "grad_reached": len(reached),
                     "launches_per_forward": per_forward, "tent_step_launches": step, "logits_rel_l2_plain": rel,
                     "logits": list(logits.shape), "finite": finite, "forward_ms_first": fwd_ms,
                     "tent_step_ms_first": step_ms, "entropy": ad.last_entropy}
        del model, logits, plain, ad, fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# ---- phase 17: the transformer segmenters ----------------------------------
# configs/model/{unetr,swin_unetr}.yaml at their paper widths in the HECKTOR21
# recipe: (norm calls of one forward, (param tensors, norm affines Tent adapts))
TRANSFORMERS = {"unetr": (16, (267, 82)), "swin_unetr": (22, (238, 94))}
TRANSFORMER_TRAIN_VOLUMES, TRANSFORMER_VAL_VOLUMES = 16, 4  # phase 11's: 2 steps of batch 8 an epoch
TRANSFORMER_TTA_BATCHES, TRANSFORMER_SERVING_STEPS = 2, 4
TRANSFORMER_TTA_RUNS = BRATS_TTA_RUNS[:3]  # none, Tent episodic (post), Tent continual (inline)
# the f32 Tent step, kernel vs plain norm: a small input the patch grids divide
TRANSFORMER_SMALL = {"unetr": (32, 64, 64), "swin_unetr": (16, 32, 32)}


def transformer_overrides(name: str, *extra: str) -> list:
    """The HECKTOR21 recipe of configs/ with ``model=name`` and remat on
    (every rematerialized norm launches its forward again in the backward),
    surface metrics on, seed 0, then ``extra``."""
    return ["task=hecktor21", "dataset=hecktor21", f"model={name}", "training.remat=true", "task.seed=0",
            "evaluation.surface.enable=true", f"evaluation.surface.nsd_tol={NSD_TOL}", *extra]


def remat_norms(model) -> int:
    """InstanceNorm calls a backward runs again under the model's remat, by
    the reference's rule (``unetr.py:154-160``, ``swin_unetr.py:288-292``):
    a level n is rematerialized when n < the remat level count (all levels,
    the encoder's too, under ``True``). UNETR: the stem pair at level 0, the
    ``dec{k}`` pair at level k, the skip branches never (they are outside
    ``run``). SwinUNETR: the bottleneck pair at level ``stages + 1``, the
    ``enc{j}_`` and ``dec{j}_`` pairs at level j; its encoder has no
    InstanceNorm."""
    if type(model).__name__ == "UNETR":
        levels = model.levels
        rl = levels + 1 if model.remat is True else int(model.remat or 0)
        return 2 * (0 < rl) + sum(2 for k in range(levels) if k < rl)
    stages = model.stages
    rl = stages + 2 if model.remat is True else int(model.remat or 0)
    return 2 * (stages + 1 < rl) + sum(4 for j in range(stages + 1) if j < rl)


def transformer_train_and_serve(device, name: str, root: str, *, shape=SHAPE[:3], small=None, extra=(),
                                reset_counts=lambda: None, read_counts=lambda: {}, per_forward: int = 16) -> dict:
    """Phase 17 for one transformer (``name``): training through
    ``ExperimentManager`` with the HECKTOR21 recipe (``transformer_overrides``:
    batch 8, adam, remat) for 2 epochs over ``TRANSFORMER_TRAIN_VOLUMES``
    synthetic volumes of ``shape`` with validation (surface metrics) each
    epoch; its trained weights through ``TTAEngine.evaluate``
    (``TRANSFORMER_TTA_RUNS``); the Tent serving step, online (continual,
    inline) and strict (episodic, post); one f32 Tent step on a ``small``
    input (default ``TRANSFORMER_SMALL``) through the kernel and through the
    plain norm.

    Checks what holds on any device: finite losses, every tensor moved; the
    launches of every step, validation batch, run and serving step exactly
    as ``per_forward`` norm calls a forward, ``remat_norms`` of them again
    in a backward, and the step structure derive them; each validation
    EDT bitwise its plain version; finite metrics in range; the model bitwise
    its trained weights after each run; the f32 step's entropy, norm deltas
    and predictions (phase 5's limits). The caller holds the numbers."""
    import shutil
    import statistics

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import ConfigNode, compose
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.data import HostLoader, get_seg_transforms
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.models.layers import set_plain_norm
    from multimodal_tta_tpu_torch.registry import get_model
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def base(*o):
        return transformer_overrides(name, *o, *extra)

    shutil.rmtree(root, ignore_errors=True)
    configs = os.path.join(REPO, "configs")
    out: dict = {}
    size = "training.data.transforms.image_size=[" + ",".join(map(str, shape)) + "]"
    train_set = hecktor_volumes(TRANSFORMER_TRAIN_VOLUMES, 51, shape)
    val_set = hecktor_volumes(TRANSFORMER_VAL_VOLUMES, 52, shape)
    vols = hecktor_volumes(BATCH * TRANSFORMER_TTA_BATCHES, 53, shape)
    spec = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                              image_size=list(shape), intensity_policy=HECKTOR_POLICY,
                              channel_names=["ct", "pt"], on_device=True).device_spec()

    run_dir = os.path.join(root, "train")
    cfg = compose(configs, "config", base(size, "training.epochs=2", "training.scheduler.name=poly",
                                          "training.eval_test.every_n_epochs=1", f"task.save_dir={run_dir}",
                                          f"hydra.run.dir={run_dir}"))
    batch = int(cfg.training.batch_size)
    m = ExperimentManager(cfg, device=dev)
    model = m.setup_model()
    m.setup_optimizer()
    m.setup_scheduler()
    m.train_loader = HostLoader(train_set, batch_size=batch, shuffle=True, drop_last=True, num_workers=2, seed=0)
    m.val_loader = HostLoader(val_set, batch_size=int(cfg.training.eval_batch_size), num_workers=2)
    m.device_transform = spec
    m.setup_trainer()
    recompute = remat_norms(model)

    class StepRecorder(HookBase):
        def __init__(self):
            self.launches, self.losses, self.ms = [], [], []

        def before_train_step(self):
            sync()
            self._at, self._t = read_counts(), time.perf_counter()

        def after_train_step(self):
            sync()
            self.ms.append((time.perf_counter() - self._t) * 1e3)
            got = read_counts()
            self.launches.append({k: got[k] - self._at[k] for k in got})
            self.losses.append(self.trainer._pending_loss)

    rec = StepRecorder()
    m.trainer.register_hooks([rec])
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    val_edt = []

    def recording_edt(pts, spacing, *, sqrt=False):
        got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        val_edt.append((pts.clone(), spacing, sqrt, got.clone()))
        return got

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    surface_module.squared_edt_volumes = recording_edt
    reset_counts()
    t0 = time.perf_counter()
    try:
        history = m.train(2)
        sync()
    finally:
        surface_module.squared_edt_volumes = squared_edt_volumes
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    losses = [float(v) for v in rec.losses]
    unmoved = sorted(n for n, p in model.named_parameters() if torch.equal(p, params0[n]))
    n_steps, n_val = len(losses), 2 * len(m.val_loader)
    step_want = {"forward": per_forward + recompute, "backward": per_forward}
    run_want = {"forward": n_steps * (per_forward + recompute) + n_val * per_forward,
                "backward": n_steps * per_forward, "minplus": n_val}
    edt = [{"shape": list(pts.shape), "with_points": int(pts.flatten(1).any(1).sum()),
            "bitwise_plain": torch.equal(got, squared_edt_volumes_plain(pts, spacing, sqrt=root_))}
           for pts, spacing, root_, got in val_edt]
    del val_edt
    out["train"] = {"wall_s": wall, "losses": losses, "step_ms": rec.ms, "step_launches": rec.launches,
                    "launches": counts, "want": run_want, "step_want": step_want, "unmoved": unmoved,
                    "recompute": recompute, "batch": batch,
                    "params": (len(params0), sum(norm_param_mask(model).values())), "peak_gib": peak / 2**30,
                    "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]],
                    "edt": edt, "steps": n_steps, "val_batches": n_val}
    if n_steps != 2 * (TRANSFORMER_TRAIN_VOLUMES // batch) or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} training: {n_steps} steps, losses {losses}")
    if unmoved:
        raise AssertionError(f"{name} training left {unmoved} unmoved")
    if not all(_counted(s, step_want) for s in rec.launches) or not _counted(counts, run_want):
        raise AssertionError(f"{name} training launches {rec.launches} / {counts}, derived {step_want} / {run_want}")
    if len(edt) != n_val or not all(e["bitwise_plain"] for e in edt):
        raise AssertionError(f"{name} validation EDT: {edt}")
    for ev in history["eval_history"]:
        bad = {k: v for k, v in ev.items() if not math.isfinite(float(v))}
        if bad or "gtvt_hd95" not in ev:
            raise AssertionError(f"{name} validation: {bad or sorted(ev)}")

    # warm steps on device-resident batches: ms a step, volumes/s, peak memory
    trainer = m.trainer
    dev_batches = [{"image": torch.from_numpy(np.stack([v["image"] for v in train_set[k:k + batch]])).to(dev),
                    "label": torch.from_numpy(np.stack([v["label"] for v in train_set[k:k + batch]])).to(dev),
                    "_n_valid": batch} for k in (0, batch)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    warm = []
    for i in range(4):
        sync()
        t0 = time.perf_counter()
        trainer.run_step(dev_batches[i % 2])
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    trainer.flush_step_metrics()
    med = statistics.median(warm[1:])
    out["train"].update(warm_step_ms=warm, median_step_ms=med, volumes_per_s=batch * 1e3 / med,
                        warm_peak_gib=(torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30)
    del dev_batches, trainer
    m.trainer.state.optimizer.zero_grad(set_to_none=True)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    shutil.rmtree(run_dir, ignore_errors=True)

    # ---- TTAEngine.evaluate on the trained weights -------------------------
    batches = [{"image": np.stack([v["image"] for v in vols[k:k + BATCH]]),
                "label": np.stack([v["label"] for v in vols[k:k + BATCH]]),
                "domain": [v["domain"] for v in vols[k:k + BATCH]]} for k in range(0, len(vols), BATCH)]
    tta = tta_phase(dev, model, batches, runs=TRANSFORMER_TTA_RUNS, base=lambda *o: base(size, *o),
                    device_transform=spec, reset_counts=reset_counts, read_counts=read_counts)
    out["tta"] = {}
    for tag, r in tta.items():
        f, b = expected_tta_launches(r["adapter"], r["batches"], r["traces"], per_forward, recompute)
        want = {"forward": f, "backward": b, "minplus": r["batches"]}
        if not _counted(r["launches"], want) or not r["model_unchanged"]:
            raise AssertionError(f"{name} {tag}: launches {r['launches']}, derived {want}")
        out["tta"][tag] = {"ms_per_batch": r["ms_per_batch"], "launches": r["launches"], "want": want,
                           "traces": r["traces"], "metrics": {k: v for k, v in r["metrics"].items() if "/" not in k}}
    del tta

    # the Tent serving step: inline (continual) and post (episodic) predictions
    out["serving"] = {}
    for proto, predict, episodic in (("online", "inline", False), ("strict", "post", True)):
        cfg_s = compose(configs, "config", base(size, "tta=tent", f"tta.episodic={str(episodic).lower()}",
                                                f"tta.predict={predict}"))
        ad = TentAdapter(cfg_s.tta, config=cfg_s, device_transform=DEVICE_TRANSFORM, device=dev)
        step = ad.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode=predict)
        times, ents = [], []
        reset_counts()
        for i in range(TRANSFORMER_SERVING_STEPS):
            sync()
            t0 = time.perf_counter()
            _, pred = step(model, torch.from_numpy(batches[i % len(batches)]["image"]).to(dev), BATCH)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            ents.append(ad.last_entropy)
        counts = read_counts()
        params = dict(model.named_parameters())
        names = [n for n, v in norm_param_mask(model).items() if v]
        reached = [n for n in names if params[n].grad is not None and bool(params[n].grad.abs().max() > 0)
                   and bool(torch.isfinite(params[n].grad).all())]
        ad.restore()
        per_step = per_forward * (2 if predict == "post" else 1) + recompute
        want = {"forward": TRANSFORMER_SERVING_STEPS * per_step, "backward": TRANSFORMER_SERVING_STEPS * per_forward}
        out["serving"][proto] = {"ms_per_step": times, "launches": counts, "want": want, "entropy": ents,
                                 "grad_reached": len(reached), "norm_tensors": len(names),
                                 "volumes_per_s": BATCH * 1e3 / statistics.median(times[1:])}
        if pred.dtype != torch.uint8 or tuple(pred.shape) != (BATCH,) + tuple(shape) + (1,):
            raise AssertionError(f"{name} serving {proto}: predictions {pred.dtype} {tuple(pred.shape)}")
        if not _counted(counts, want) or len(reached) != len(names) or not all(map(math.isfinite, ents)):
            raise AssertionError(f"{name} serving {proto}: launches {counts}, derived {want}; gradient in "
                                 f"{len(reached)} of {len(names)} norm tensors; entropy {ents}")
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, trained[k])]
    if changed:
        raise AssertionError(f"{name} serving left {changed[:3]} changed")
    del model, m, trained

    # one f32 Tent step on a small input, kernel against plain norm
    small = tuple(small or TRANSFORMER_SMALL[name])
    small_cfg = compose(configs, "config", base())
    x = torch.from_numpy(np.stack([v["image"] for v in hecktor_volumes(1, 54, small)])).to(dev)
    m32 = get_model(name).from_config(small_cfg.model, dtype=torch.float32, remat=False, image_size=small,
                                      device=dev, seed=3)
    src = {k: v.detach().clone() for k, v in m32.state_dict().items()}
    got = {}
    for plain in (False, True):
        m32.load_state_dict(src)
        set_plain_norm(m32, plain)
        cfg_p = ConfigNode({"tta": {"steps": 1, "lr": 1e-3, "momentum": 0.9, "episodic": True}})
        ad = TentAdapter(cfg_p.tta, config=cfg_p, device_transform=DEVICE_TRANSFORM, device=dev)
        _, pred = ad.make_adapt_predict_fn(m32, threshold=THRESHOLD, predict_mode="post")(m32, x, 1)
        delta = torch.cat([(p.detach() - src[n]).flatten() for n, p in m32.named_parameters() if p.requires_grad])
        got[plain] = (ad.last_entropy, delta, pred)
    (e_k, d_k, p_k), (e_p, d_p, p_p) = got[False], got[True]
    out["f32_step"] = {"input": [1, *small, 2], "entropy_rel": abs(e_k - e_p) / abs(e_p),
                       "delta_rel": float((d_k - d_p).norm() / d_p.norm()),
                       "predictions_agree": float((p_k == p_p).float().mean())}
    f32 = out["f32_step"]
    if not (f32["entropy_rel"] <= 1e-4 and f32["delta_rel"] <= 1e-3 and f32["predictions_agree"] >= 0.999):
        raise AssertionError(f"{name}: the f32 Tent step through the kernel disagrees with the plain norm: {f32}")
    del m32
    if cuda:
        torch.cuda.empty_cache()
    return out


def transformer_cli(device, name: str, manifest: str, root: str, *, extra=(), reset_counts=lambda: None,
                    read_counts=lambda: {}, per_forward: int = 16) -> dict:
    """Phase 17, the CLIs: ``cli.train`` (the stock recipe, no remat, one
    epoch), ``cli.adapt`` (Tent, the no-adapt report, surface metrics) and
    ``cli.predict`` (continual Tent, masks written) with ``model=name`` on
    phase 14's HECKTOR21 fixture. Checks the best checkpoint, finite losses,
    the report's schema and ranges, a mask file per test case, and each
    call's launches exactly: ``per_forward`` norm calls a forward, a
    training step one forward and one backward, an adapted test batch three
    forwards (no-adapt, the Tent step, the post-update forward) and one
    backward, a predicted one two forwards and one backward."""
    import csv

    import numpy as np

    from multimodal_tta_tpu_torch.cli import adapt, predict, train
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager

    managers = []
    orig = ExperimentManager.setup_optimizer

    def setup_optimizer(self):  # each CLI calls it once: the manager it built
        managers.append(self)
        return orig(self)

    def run(cli, tag: str, *more: str):
        run_dir = os.path.join(root, f"{name}_{tag}")
        reset_counts()
        t1 = time.perf_counter()
        try:
            result = cli.main(cli_overrides(manifest, run_dir, "training.epochs=1", *more, *extra, model=name),
                              device=device)
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        return result, run_dir, time.perf_counter() - t1, read_counts()

    out: dict = {}
    ExperimentManager.setup_optimizer = setup_optimizer
    try:
        history, run_dir, wall, counts = run(train, "train")
        mt = managers[-1]
        steps, val = len(mt.train_loader), len(mt.val_loader)
        want = {"forward": per_forward * (steps + val), "backward": per_forward * steps, "minplus": val}
        losses = [h["loss"] for h in history["train_history"]]
        out["train"] = {"wall_s": wall, "launches": counts, "want": want, "steps": steps, "val_batches": val,
                        "losses": losses, "model": type(mt.model).__name__,
                        "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]]}
        best = os.path.join(run_dir, "checkpoints", "best_model")
        if not os.path.isfile(best + ".msgpack") or not all(np.isfinite(losses)) or not _counted(counts, want):
            raise AssertionError(f"{name} cli.train: {out['train']}")

        results, run_dir, wall, counts = run(adapt, "adapt", "tta=tent", "tta.steps=1", "tta.report_no_adapt=true",
                                             f"training.resume={best}")
        with open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8") as f:
            written = json.load(f)
        b = len(managers[-1].test_loader)
        want = {"forward": 3 * per_forward * b, "backward": per_forward * b, "minplus": 2 * b}
        out["adapt"] = {"wall_s": wall, "launches": counts, "want": want, "test_batches": b,
                        "metrics": {mode: {k: v for k, v in r.items() if "/" not in k} for mode, r in written.items()}}
        if written != json.loads(json.dumps(results)) or set(written) != {"no_adapt", "adapted"}:
            raise AssertionError(f"{name} tta_metrics.json: {sorted(written)}")
        for mode, r in written.items():
            for k, v in r.items():
                bounded = k.endswith(("_dc", "_iou", "_nsd")) or k.split("/")[-1] in ("avg_dc", "avg_iou")
                if not math.isfinite(v) or v < 0 or (bounded and v > 1) or "gtvt_hd95" not in r:
                    raise AssertionError(f"{name} cli.adapt {mode}: {k} = {v}")
        if not _counted(counts, want):
            raise AssertionError(f"{name} cli.adapt: launches {counts}, derived {want}")

        rows, run_dir, wall, counts = run(predict, "predict", "tta=tent", "tta.episodic=false",
                                          f"training.resume={best}")
        pred_dir = os.path.join(run_dir, "predictions")
        with open(os.path.join(pred_dir, "predictions.csv"), newline="", encoding="utf-8") as f:
            written = list(csv.DictReader(f))
        b = len(managers[-1].test_loader)
        want = {"forward": 2 * per_forward * b, "backward": per_forward * b}  # the Tent step, the inline forward
        ok = [r["status"] == "ok" and os.path.isfile(os.path.join(pred_dir, r["files"])) for r in written]
        out["predict"] = {"wall_s": wall, "launches": counts, "want": want, "test_batches": b, "cases": len(written),
                          "voxels": [int(r["voxels_gtvt"]) for r in written]}
        if not written or len(rows) != len(written) or not all(ok) or not _counted(counts, want):
            raise AssertionError(f"{name} cli.predict: {out['predict']}, rows ok {ok}")
    finally:
        ExperimentManager.setup_optimizer = orig
        managers.clear()
    return out


# ---- phase 18: BatchNorm ----------------------------------------------------
# 18.1: the flagship with model.norm=BATCH in the HECKTOR21 recipe: its
# TTAEngine.evaluate runs (3 batches of 2) and the methods cli.adapt runs on
# the checkpoint of a BATCH cli.train. 18.2: the classifiers in Tent's
# ImageNet-C setting (Wang et al., ICLR 2021, section 4: ResNet-50, batch 64,
# 224x224, SGD lr 2.5e-4 momentum 0.9, the BN affines, continual) and the
# registry default of each family at batch 16.
BN_NORMS = 18  # the flagship's BatchNorms with model.norm=BATCH, one per InstanceNorm of the stock model
BN_EVAL_BATCHES, BN_WARM_STEPS, BN_SERVING_STEPS = 3, 8, 4
BN_EVAL_RUNS = [
    ("none", ["tta=none"]),
    ("norm_episodic", ["tta=norm"]),
    ("norm_continual", ["tta=norm", "tta.episodic=false"]),
    ("tent_episodic_post", ["tta=tent", "tta.episodic=true", "tta.predict=post"]),
    ("tent_continual_inline", ["tta=tent", "tta.episodic=false", "tta.predict=inline"]),
]
BN_CLI_METHODS = ("norm", "tent", "sar", "cotta", "memo")
BN_STATS_REL = 1e-5  # running statistics after one norm step vs f64 on the host, of each tensor's largest value
CLS_BATCH, CLS_SIDE, CLS_CLASSES, CLS_STEPS = 64, 224, 1000, 8
CLS_FAMILIES = ("resnet18", "densenet121", "efficientnet_b0", "efficientnet_v2_s", "vit_b_16")
CLS_FAMILY_BATCH, CLS_PARITY_BATCH = 16, 4
CLS_PARITY_REL_L2 = 1e-3  # resnet50 f32 on the card (TF32 off) vs the port on the CPU
# the adapted affines' deltas alone: the f32 step itself is 2.1e-2 off an f64
# run on the CPU (measured at this batch; BN -> ReLU -> conv -> BN makes the
# entropy nearly invariant to an earlier BN's scale, so its gradient cancels)
CLS_PARITY_DELTA_REL_L2 = 5e-2
CLS_OTHER_METHODS = ("norm", "sar", "memo", "cotta")


def bn_overrides(*extra: str) -> list:
    """The HECKTOR21 recipe of configs/ with ``model.norm=BATCH``, surface
    metrics on, seed 0, then ``extra``."""
    return tta_overrides("model.norm=BATCH", "task.seed=0", *extra)


def batchnorm_flagship(device, root: str, *, shape=SHAPE[:3], extra=(), reset_counts=lambda: None,
                       read_counts=lambda: {}) -> dict:
    """Phase 18.1 in process: the flagship UNet3D with ``model.norm=BATCH``
    built by ``ExperimentManager`` from the HECKTOR21 recipe.

      - training steps at the recipe's batch on device-resident batches
        (median of ``BN_WARM_STEPS`` warm ones, peak memory), no norm kernel
        launched, the running statistics moved every step;
      - one step of the same model with remat (every level) moves the
        running statistics as the step without it does (once);
      - one ``norm`` step: the running statistics equal
        ``0.9 * ra + 0.1 * (mean, biased var)`` of each BatchNorm's input,
        taken in f64 on the host (``BN_STATS_REL``);
      - ``TTAEngine.evaluate`` for ``BN_EVAL_RUNS`` over ``BN_EVAL_BATCHES``
        batches: one min-plus launch per batch and no norm launch, each
        batch's EDT input bitwise through the kernel and its plain version,
        params and buffers bitwise the source afterwards;
      - the Tent serving step (continual, inline): ms per step;
      - a checkpoint round trip: params and buffers bitwise.
    The caller holds the times."""
    import shutil
    import statistics

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.data import get_seg_transforms
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.models.layers import BatchNorm, InstanceNorm, running_statistics
    from multimodal_tta_tpu_torch.tta.norm_adapt import NormAdapter
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    shutil.rmtree(root, ignore_errors=True)
    configs = os.path.join(REPO, "configs")
    spec = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                              image_size=list(shape), intensity_policy=HECKTOR_POLICY,
                              channel_names=["ct", "pt"], on_device=True).device_spec()
    out: dict = {}

    def manager(*more):
        cfg = compose(configs, "config", bn_overrides(f"task.save_dir={root}", f"hydra.run.dir={root}", *more, *extra))
        m = ExperimentManager(cfg, device=dev)
        m.setup_model()
        m.setup_optimizer()
        m.setup_scheduler()
        m.device_transform = spec
        m.setup_trainer(root)
        return m

    m = manager()
    model, trainer = m.model, m.trainer
    batch = int(m.config.training.batch_size)
    bns = [mod for mod in model.modules() if isinstance(mod, BatchNorm)]
    n_params, n_norm = len(list(model.parameters())), sum(norm_param_mask(model).values())
    if len(bns) != BN_NORMS or any(isinstance(mod, InstanceNorm) for mod in model.modules()) or n_norm != 2 * BN_NORMS:
        raise AssertionError(f"the BATCH flagship has {len(bns)} BatchNorms, {n_params} tensors ({n_norm} norm)")

    # ---- training steps at the recipe's batch -------------------------------
    train_set = hecktor_volumes(2 * batch, 61, shape)
    dev_batches = [{"image": torch.from_numpy(np.stack([v["image"] for v in train_set[k:k + batch]])).to(dev),
                    "label": torch.from_numpy(np.stack([v["label"] for v in train_set[k:k + batch]])).to(dev),
                    "_n_valid": batch} for k in (0, batch)]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    times, losses, moved = [], [], []
    reset_counts()
    for i in range(1 + BN_WARM_STEPS):
        before = running_statistics(model)
        sync()
        t0 = time.perf_counter()
        trainer.run_step(dev_batches[i % 2])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        moved.append(sum(not torch.equal(t, before[k]) for k, t in running_statistics(model).items()))
        losses.append(float(trainer._pending_loss))
    counts = read_counts()
    trainer.flush_step_metrics()
    med = statistics.median(times[1:])
    out["train"] = {"batch": batch, "step_ms": times, "median_step_ms": med, "volumes_per_s": batch * 1e3 / med,
                    "peak_gib": (torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30, "losses": losses,
                    "launches": counts, "params": [n_params, n_norm]}
    if not all(np.isfinite(losses)) or any(n != 2 * BN_NORMS for n in moved) or not _counted(counts, {}):
        raise AssertionError(f"BATCH training: losses {losses}, statistics moved {moved}, launches {counts}")

    # ---- remat moves the running statistics once ----------------------------
    m_r = manager("training.remat=true")
    m_r.model.load_state_dict(model.state_dict())
    src = {k: v.detach().clone() for k, v in model.state_dict().items()}
    after = {}
    for tag, t in (("plain", trainer), ("remat", m_r.trainer)):
        t.state.model.load_state_dict(src)
        img = dev_batches[0]["image"].float()
        t._step(img, dev_batches[0]["label"], batch)
        after[tag] = running_statistics(t.state.model)
    stats_rel = max(float((after["remat"][k] - after["plain"][k]).abs().max() / after["plain"][k].abs().max())
                    for k in after["plain"])
    moved_rel = min(float((after["plain"][k] - src[k]).abs().max() / src[k].abs().max()) for k in after["plain"])
    out["remat"] = {"stats_rel_vs_plain": stats_rel, "stats_bitwise": all(
        torch.equal(after["remat"][k], after["plain"][k]) for k in after["plain"]), "min_move_rel": moved_rel}
    if not stats_rel <= 1e-5 or not moved_rel > 0.0:
        raise AssertionError(f"a remat step moves the running statistics otherwise than a plain step: {out['remat']}")
    model.load_state_dict(src)
    ckpt = os.path.join(root, "bn_roundtrip")
    save_checkpoint(ckpt, m.state)
    got, _ = load_checkpoint(ckpt, m_r.state)
    want_sd, got_sd = m.state.model.state_dict(), got.model.state_dict()
    out["checkpoint_bitwise"] = set(want_sd) == set(got_sd) and all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    if not out["checkpoint_bitwise"] or len(running_statistics(got.model)) != 2 * BN_NORMS:
        raise AssertionError("the checkpoint round trip lost the BATCH model's buffers")
    del m_r, got, after, dev_batches

    # ---- one norm step against f64 on the host -------------------------------
    vols = hecktor_volumes(BATCH * BN_EVAL_BATCHES, 62, shape)
    batches = [{"image": np.stack([v["image"] for v in vols[k:k + BATCH]]),
                "label": np.stack([v["label"] for v in vols[k:k + BATCH]]),
                "domain": [v["domain"] for v in vols[k:k + BATCH]]} for k in range(0, len(vols), BATCH)]
    ra = running_statistics(model)
    inputs = {}
    names = {mod: n for n, mod in model.named_modules() if isinstance(mod, BatchNorm)}
    hooks = [mod.register_forward_pre_hook(lambda mod, args: inputs.__setitem__(names[mod], args[0].detach().cpu()))
             for mod in bns]
    cfg_n = compose(configs, "config", bn_overrides("tta=norm", *extra))
    ad = NormAdapter(cfg_n.tta, config=cfg_n, device_transform=DEVICE_TRANSFORM, device=dev)
    reset_counts()
    ad.make_adapt_fn(model)(model, torch.from_numpy(batches[0]["image"]).to(dev), BATCH)
    sync()
    norm_counts = read_counts()
    for h in hooks:
        h.remove()
    got_stats, worst = running_statistics(model), 0.0
    for name, x in inputs.items():
        x64 = x.double().movedim(1, -1).reshape(-1, x.shape[1])
        mean = x64.mean(0)
        var = (x64 * x64).mean(0) - mean * mean
        for k, batch_stat in (("mean", mean), ("var", var)):
            want = 0.9 * ra[f"{name}.{k}"].double().cpu() + 0.1 * batch_stat
            err = float((got_stats[f"{name}.{k}"].double().cpu() - want).abs().max() / want.abs().max())
            worst = max(worst, err)
    ad.restore()
    restored = all(torch.equal(t, ra[k]) for k, t in running_statistics(model).items())
    out["norm_step"] = {"layers": len(inputs), "stats_rel_vs_f64": worst, "launches": norm_counts,
                        "restored": restored}
    del inputs
    if out["norm_step"]["layers"] != BN_NORMS or not worst <= BN_STATS_REL or not restored \
            or not _counted(norm_counts, {}):
        raise AssertionError(f"the norm step's running statistics: {out['norm_step']}")

    # ---- TTAEngine.evaluate: none, norm, Tent ---------------------------------
    edt_in = []

    def recording_edt(pts, spacing, *, sqrt=False):
        got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        edt_in.append((pts.clone(), spacing, sqrt, got.clone()))
        return got

    surface_module.squared_edt_volumes = recording_edt
    try:
        runs = tta_phase(dev, model, batches, runs=BN_EVAL_RUNS, base=bn_overrides, extra=extra,
                         reset_counts=reset_counts, read_counts=read_counts)
    finally:
        surface_module.squared_edt_volumes = squared_edt_volumes
    out["evaluate"] = {}
    want = {"forward": 0, "backward": 0, "minplus": BN_EVAL_BATCHES}
    for tag, r in runs.items():
        out["evaluate"][tag] = {"ms_per_batch": r["ms_per_batch"], "launches": r["launches"], "want": want,
                                "traces": r["traces"], "unchanged": r["model_unchanged"],
                                "metrics": {k: v for k, v in r["metrics"].items() if "/" not in k}}
        if not _counted(r["launches"], want) or not r["model_unchanged"]:
            raise AssertionError(f"BATCH evaluate {tag}: launches {r['launches']} (derived {want})")
    edt = [torch.equal(got, squared_edt_volumes_plain(pts, spacing, sqrt=root_)) for pts, spacing, root_, got in edt_in]
    pts, spacing, root_, _ = edt_in[0]
    out["edt"] = {"batches": len(edt), "bitwise_plain": all(edt), "shape": list(pts.shape)}
    if cuda:
        out["edt"].update(ms=cuda_ms(lambda: squared_edt_volumes(pts, spacing, sqrt=root_), iters=10),
                          plain_ms=cuda_ms(lambda: squared_edt_volumes_plain(pts, spacing, sqrt=root_), iters=10))
    del edt_in, runs
    if len(edt) != BN_EVAL_BATCHES * len(BN_EVAL_RUNS) or not all(edt):
        raise AssertionError(f"BATCH evaluation EDT: {out['edt']}")

    # ---- the Tent serving step (continual, inline) -----------------------------
    source = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg_s = compose(configs, "config", bn_overrides("tta=tent", "tta.episodic=false", "tta.predict=inline", *extra))
    ad = TentAdapter(cfg_s.tta, config=cfg_s, device_transform=DEVICE_TRANSFORM, device=dev)
    step = ad.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode="inline")
    serve_ms, ents = [], []
    reset_counts()
    for i in range(BN_SERVING_STEPS):
        sync()
        t0 = time.perf_counter()
        _, pred = step(model, torch.from_numpy(batches[i % len(batches)]["image"]).to(dev), BATCH)
        sync()
        serve_ms.append((time.perf_counter() - t0) * 1e3)
        ents.append(ad.last_entropy)
    counts = read_counts()
    moved = sum(not torch.equal(t, source[k]) for k, t in running_statistics(model).items())
    ad.restore()
    unchanged = all(torch.equal(v, source[k]) for k, v in model.state_dict().items())
    out["serving"] = {"ms_per_step": serve_ms, "volumes_per_s": BATCH * 1e3 / statistics.median(serve_ms[1:]),
                      "entropy": ents, "launches": counts, "statistics_moved": moved, "restored": unchanged}
    if pred.dtype != torch.uint8 or tuple(pred.shape) != (BATCH,) + tuple(shape) + (1,) \
            or not all(map(math.isfinite, ents)) or moved != 2 * BN_NORMS or not unchanged \
            or not _counted(counts, {}):
        raise AssertionError(f"BATCH serving: {out['serving']}")
    del model, m, trainer
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``, by CUDA events."""
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def batchnorm_cli(device, manifest: str, root: str, *, extra=(), reset_counts=lambda: None,
                  read_counts=lambda: {}) -> dict:
    """Phase 18.1, the CLIs: ``cli.train`` with ``model.norm=BATCH`` (the
    stock recipe, one epoch) on phase 14's fixture, then ``cli.adapt`` with
    each of ``BN_CLI_METHODS`` from its best checkpoint. Checks the
    checkpoint holds the running statistics, finite losses and metrics, and
    each call's launches exactly: no norm kernel, one min-plus launch per
    evaluated batch."""
    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.cli import adapt, train
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager

    managers = []
    orig = ExperimentManager.setup_optimizer

    def setup_optimizer(self):  # each CLI calls it once: the manager it built
        managers.append(self)
        return orig(self)

    def run(cli, tag: str, *more: str):
        run_dir = os.path.join(root, tag)
        reset_counts()
        t1 = time.perf_counter()
        try:
            result = cli.main(cli_overrides(manifest, run_dir, "model.norm=BATCH", "training.epochs=1", *more, *extra),
                              device=device)
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        return result, run_dir, time.perf_counter() - t1, read_counts()

    out: dict = {}
    ExperimentManager.setup_optimizer = setup_optimizer
    try:
        history, run_dir, wall, counts = run(train, "train")
        mt = managers[-1]
        steps, val = len(mt.train_loader), len(mt.val_loader)
        want = {"forward": 0, "backward": 0, "minplus": val}
        losses = [h["loss"] for h in history["train_history"]]
        best = os.path.join(run_dir, "checkpoints", "best_model")
        saved = saved_state_dict(best)
        buffers = sorted(k for k in saved if k.rpartition(".")[2] in ("mean", "var"))
        out["train"] = {"wall_s": wall, "launches": counts, "want": want, "steps": steps, "val_batches": val,
                        "losses": losses, "checkpoint_buffers": len(buffers),
                        "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]]}
        if len(buffers) != 2 * BN_NORMS or not all(np.isfinite(losses)) or not _counted(counts, want):
            raise AssertionError(f"BATCH cli.train: {out['train']}")
        for method in BN_CLI_METHODS:
            results, run_dir, wall, counts = run(adapt, f"adapt_{method}", f"tta={method}", f"training.resume={best}")
            b = len(managers[-1].test_loader)
            want = {"forward": 0, "backward": 0, "minplus": b}
            metrics = {k: v for k, v in results["adapted"].items() if "/" not in k}
            out[f"adapt_{method}"] = {"wall_s": wall, "launches": counts, "want": want, "test_batches": b,
                                      "metrics": metrics}
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v) or v < 0}
            if bad or "gtvt_hd95" not in metrics or not _counted(counts, want):
                raise AssertionError(f"BATCH cli.adapt tta={method}: {out[f'adapt_{method}']}")
    finally:
        ExperimentManager.setup_optimizer = orig
        managers.clear()
    return out


def classifier_phase(device, root: str, *, side: int = CLS_SIDE, batch: int = CLS_BATCH, classes: int = CLS_CLASSES,
                     families=CLS_FAMILIES, family_batch: int = CLS_FAMILY_BATCH, parity_batch: int = CLS_PARITY_BATCH,
                     steps: int = CLS_STEPS, reset_counts=lambda: None, read_counts=lambda: {}) -> dict:
    """Phase 18.2, the classifiers through ``classifier_logits_apply``:

      - ResNet-50 in Tent's ImageNet-C setting on [batch, side, side, 3]:
        the continual Tent serving step (inline predictions), bf16 and f32,
        median of ``steps`` after a warm-up and peak memory; only BN affines
        move, the running statistics move, no kernel launch;
      - one step each of ``CLS_OTHER_METHODS``: a finite entropy (norm has
        none), only BN affines move, the running statistics move, restore()
        puts the model back bitwise;
      - each family's registry default loaded through
        ``ExperimentManager.setup_model`` with ``model.pretrained=true`` from
        a torchvision-named state dict written from random weights
        (``to_torchvision``): bitwise the weights written, a forward and a
        continual Tent step at ``family_batch`` (each timed at its second
        call);
      - ResNet-50's f32 logits, and its BN affines and running statistics
        after one Tent step, on ``device`` against the port on the CPU at
        ``parity_batch`` (``CLS_PARITY_REL_L2``; the affines' deltas alone
        ``CLS_PARITY_DELTA_REL_L2``)."""
    import shutil
    import statistics

    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.models.layers import running_statistics
    from multimodal_tta_tpu_torch.models.pretrained import to_torchvision
    from multimodal_tta_tpu_torch.registry import get_model, get_tta_method
    from multimodal_tta_tpu_torch.tta import classifier_logits_apply, norm_param_mask

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def cfg_of(method: str, **tta):
        base = {"method": method, "steps": 1, "lr": 2.5e-4, "optimizer": "sgd", "momentum": 0.9, "update": "norm",
                "episodic": False, "entropy_focus": "all", "predict": "inline", "n_views": 4, "aug_flip": True}
        base.update(tta)
        return ConfigNode({"task": {"seed": 0}, "training": {"criterion": {"softmax": True, "sigmoid": False}},
                           "tta": base})

    def build(name: str, dtype, seed, dev_=dev, n_classes=classes):
        return get_model(name).from_config(ConfigNode({"name": name, "num_classes": n_classes}), dtype=dtype,
                                           device=dev_, seed=seed)

    def moved_only_affines(model, source) -> tuple:
        mask = norm_param_mask(model)
        stats = running_statistics(model)
        params_ok = all(mask[n] or torch.equal(p, source[n]) for n, p in model.named_parameters())
        affines = any(mask[n] and not torch.equal(p, source[n]) for n, p in model.named_parameters())
        return params_ok, affines, all(not torch.equal(t, source[k]) for k, t in stats.items())

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(batch, side, side, 3, generator=gen, device=dev) * 1.5 + 0.3  # shifted input statistics
    out: dict = {"resnet50": {}}

    # ---- ResNet-50, Tent's ImageNet-C step -------------------------------------
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        model = build("resnet50", dtype, seed=0)
        w = classifier_logits_apply(model)
        source = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cfg = cfg_of("tent")
        ad = get_tta_method("tent")(cfg.tta, config=cfg, device=dev)
        step = ad.make_adapt_predict_fn(w, threshold=0.5, predict_mode="inline")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        times, ents = [], []
        reset_counts()
        for _ in range(1 + steps):
            sync()
            t0 = time.perf_counter()
            _, pred = step(w, x, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            ents.append(ad.last_entropy)
        counts = read_counts()
        params_ok, affines, stats_moved = moved_only_affines(model, source)
        med = statistics.median(times[1:])
        out["resnet50"][f"tent_{tag}"] = {
            "ms_per_step": times, "median_ms": med, "images_per_s": batch * 1e3 / med,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30, "entropy": ents,
            "launches": counts, "input": [batch, side, side, 3]}
        if pred.dtype != torch.uint8 or tuple(pred.shape) != (batch, 1) or not all(map(math.isfinite, ents)) \
                or not (params_ok and affines and stats_moved) or not _counted(counts, {}):
            raise AssertionError(f"resnet50 Tent {tag}: {out['resnet50'][f'tent_{tag}']}, only affines moved "
                                 f"{params_ok}, affines {affines}, statistics {stats_moved}")
        ad.restore()
        if dtype == torch.float32:
            break
        del model, w, ad, step

    # ---- one step of the other methods (f32 model) -----------------------------
    for method in CLS_OTHER_METHODS:
        # random weights are uncertain everywhere: SAR's stock 0.4 H_max gate would pass no sample
        cfg = cfg_of(method, episodic=True, predict="post", **({"margin_ratio": 1.0} if method == "sar" else {}))
        ad = get_tta_method(method)(cfg.tta, config=cfg, device=dev)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ad.make_adapt_fn(w)(w, x, batch)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        params_ok, affines, stats_moved = moved_only_affines(model, source)
        ent = ad.last_entropy
        ad.restore()
        restored = all(torch.equal(v, source[k]) for k, v in model.state_dict().items())
        out["resnet50"][method] = {"ms": ms, "entropy": ent, "launches": counts, "restored": restored}
        if (method != "norm" and not (ent is not None and math.isfinite(ent) and affines)) or not params_ok \
                or not stats_moved or not restored or not _counted(counts, {}):
            raise AssertionError(f"resnet50 {method}: {out['resnet50'][method]}, only affines {params_ok}, "
                                 f"affines moved {affines}, statistics moved {stats_moved}")
    del model, w, x
    if cuda:
        torch.cuda.empty_cache()

    # ---- each family's registry default, pretrained from a torchvision file -----
    out["families"] = {}
    xf = torch.randn(family_batch, side, side, 3, generator=gen, device=dev)
    for name in families:
        src = build(name, torch.float32, seed=1, dev_=torch.device("cpu"))
        path = os.path.join(root, f"{name}.pt")
        torch.save(to_torchvision(src, name), path)
        cfg = ConfigNode({"task": {"name": "imagenet", "seed": 0}, "training": {"compute_dtype": "bfloat16"},
                          "model": {"name": name, "num_classes": classes, "pretrained": True,
                                    "pretrained_source": path}})
        t0 = time.perf_counter()
        model = ExperimentManager(cfg, device=dev).setup_model()
        load_s = time.perf_counter() - t0
        want, got = src.state_dict(), model.state_dict()
        loaded = set(want) == set(got) and all(torch.equal(got[k].cpu(), want[k]) for k in want)
        w = classifier_logits_apply(model)
        cfg_t = cfg_of("tent")
        ad = get_tta_method("tent")(cfg_t.tta, config=cfg_t, device=dev)
        adapt = ad.make_adapt_fn(w)
        fwd_ms, step_ms = [], []
        reset_counts()
        for _ in range(2):  # the first call of each sets up cuDNN's plans: the second is timed
            with torch.no_grad():
                sync()
                t0 = time.perf_counter()
                logits = w(xf)
                sync()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            adapt(w, xf, family_batch)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        ent = ad.last_entropy
        ad.restore()
        out["families"][name] = {"loaded_bitwise": loaded, "load_s": load_s, "forward_ms": fwd_ms[1],
                                 "tent_step_ms": step_ms[1], "first_call_ms": [fwd_ms[0], step_ms[0]],
                                 "entropy": ent, "launches": counts,
                                 "params": sum(p.numel() for p in model.parameters()),
                                 "norm_tensors": sum(norm_param_mask(model).values())}
        if not loaded or tuple(logits.shape) != (family_batch, classes) or not bool(torch.isfinite(logits).all()) \
                or not math.isfinite(ent) or not _counted(counts, {}):
            raise AssertionError(f"{name}: {out['families'][name]}")
        del src, model, w, ad, logits
        if cuda:
            torch.cuda.empty_cache()

    # ---- ResNet-50 f32 on the device against the port on the CPU ---------------
    xp = torch.randn(parity_batch, side, side, 3, generator=gen, device=dev) * 1.5 + 0.3
    res = {}
    source = {k: v.detach().cpu() for k, v in build("resnet50", torch.float32, seed=2).state_dict().items()}
    for where in (dev, torch.device("cpu")):
        model = build("resnet50", torch.float32, seed=None, dev_=where)
        model.load_state_dict(source)
        w = classifier_logits_apply(model)
        with torch.no_grad():
            logits = w(xp.to(where)).cpu()
        cfg = cfg_of("tent", lr=1e-2, episodic=True, predict="post")
        ad = get_tta_method("tent")(cfg.tta, config=cfg, device=where)
        ad.make_adapt_fn(w)(w, xp.to(where), parity_batch)
        mask = norm_param_mask(model)
        affines = torch.cat([p.detach().cpu().flatten() for n, p in model.named_parameters() if mask[n]])
        delta = affines - torch.cat([source[n].flatten() for n, _ in model.named_parameters() if mask[n]])
        stats = torch.cat([t.flatten().cpu() for t in running_statistics(model).values()])
        res[where.type] = (logits, affines, stats, delta)
        del model, w, ad
    rel = {k: float((a - b).norm() / b.norm())
           for k, a, b in zip(("logits", "affines", "statistics", "affine_deltas"), res[dev.type], res["cpu"])}
    out["resnet50_vs_cpu"] = {"batch": parity_batch, "rel_l2": rel}
    if not (all(rel[k] <= CLS_PARITY_REL_L2 for k in ("logits", "affines", "statistics"))
            and rel["affine_deltas"] <= CLS_PARITY_DELTA_REL_L2):
        raise AssertionError(f"resnet50 on {dev.type} vs the CPU: {rel}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 19: the serving artifact -----------------------------------------
# the two Tent artifacts of the serving step (the stock tent.yaml), the
# overrides that make each, and how many batches each serves against the
# live step on the same weights and batches
SERVING_ARTIFACT_RUNS = (("continual_inline", ["tta=tent", "tta.episodic=false", "tta.predict=inline"], 8),
                         ("episodic_post", ["tta=tent", "tta.episodic=true", "tta.predict=post"], 6))
# the other methods' pure steps, one batch each against their live step
# (SAR with every sample reliable: random weights are too uncertain for its
# stock gate, which would leave nothing to compare), on the flagship's first
# SERVING_METHODS_LEVELS levels: tracing the whole flagship's step took 10-15 s
# a method on an H100 host, and the operators it holds are the same at any depth
SERVING_METHODS_LEVELS = 3
SERVING_ARTIFACT_METHODS = (("sar", ["tta=sar", "tta.steps=1", "tta.margin_ratio=1.0"]),
                            ("cotta", ["tta=cotta", "tta.steps=1", "tta.n_views=2"]),
                            ("memo", ["tta=memo", "tta.steps=1", "tta.n_views=2"]))
ARTIFACT_PRED_AGREE = 0.999  # voxels of the artifact's predictions equal to the live step's
ARTIFACT_ENT_ABS = 1e-5  # |entropy| of a step: the artifact against the live step
ARTIFACT_DELTA_REL = 1e-3  # adapted norm tensors' deltas from source, relative L2
ARTIFACT_PROBS_ABS = 1e-5  # the forward artifact's probabilities against _probs_fn
# cases served through cli.serve_artifact: a full batch and a padded tail (each mask
# of random weights is noise, which nifti.save's gzip level 9 takes ~4 s to write)
SERVE_CASES = 3


def artifact_launches(adapter, mode: str, per_forward: int = 18) -> dict:
    """Norm forward and backward launches of one call of an adapter's
    artifact, from the step's structure (every step runs its forward and its
    backward: an early-stop freeze is a merge): per step one of each (two
    with ``+consistency``), SAR two of each, CoTTA ``n_views`` teacher
    forwards and the student's forward and backward, MEMO ``n_views``
    marginal forwards and one forward and backward per view; ``post`` adds
    the served forward, or the ensemble's ``n_views``."""
    f, k, method = per_forward, adapter.steps, adapter.method
    if method == "sar":
        fwd, bwd = 2 * f * k, 2 * f * k
    elif method == "cotta":
        fwd, bwd = (adapter.n_views + 1) * f * k, f * k
    elif method == "memo":
        fwd, bwd = 2 * adapter.n_views * f * k, adapter.n_views * f * k
    else:
        per = 2 if adapter.loss_mode.endswith("+consistency") else 1
        fwd, bwd = per * f * k, per * f * k
    if mode == "post":
        fwd += f * (adapter.n_views if adapter.serving_post(mode) else 1)
    return {"forward": fwd, "backward": bwd}


def program_norm_calls(art) -> dict:
    """The norm operator calls that an artifact's program holds."""
    import torch

    ops = {torch.ops.mtta.fused_instance_norm_forward.default: "forward",
           torch.ops.mtta.fused_instance_norm_backward.default: "backward"}
    out = {"forward": 0, "backward": 0}
    for node in art._graph.graph.nodes:
        if node.op == "call_function" and node.target in ops:
            out[ops[node.target]] += 1
    return out


def serving_artifact_phase(device, root: str, *, manifest=None, best=None, shape=SHAPE[:3], batch: int = BATCH,
                           model_kw=None, runs=SERVING_ARTIFACT_RUNS, methods=SERVING_ARTIFACT_METHODS,
                           cli_extra=(), per_forward: int = 18, reset_counts=lambda: None,
                           read_counts=lambda: {}) -> dict:
    """Phase 19: the serving artifact (``serving/export.py``) on the device.
    The flagship (or ``model_kw``) with random weights from a seed: Tent's
    continual-inline and episodic-post steps exported, saved, loaded and run
    against the live ``make_adapt_predict_fn`` on the same weights, batches
    and draws (predictions, entropies, the adapted norm tensors, ms per
    step, the norm operator calls in the program and the launches of each
    call); the forward artifact against ``_probs_fn``; SAR, CoTTA and MEMO one
    batch each on the model's first ``SERVING_METHODS_LEVELS`` levels; then,
    given phase 14's fixture and checkpoint,
    ``cli.export_serving`` and ``cli.serve_artifact`` (every row ok, uint8
    masks in the source grid). Raises on any check that holds on every
    device; the caller holds the launch counts (``read_counts``, zeroed by
    ``reset_counts`` before each call) against ``want``."""
    import csv
    import gc
    import shutil
    import statistics
    import threading

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.tta  # noqa: F401  (registers the methods)
    from multimodal_tta_tpu_torch.cli import CONFIG_DIR, export_serving, serve_artifact
    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.data import nifti
    from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.ops.augment import group_draws
    from multimodal_tta_tpu_torch.registry import get_tta_method
    from multimodal_tta_tpu_torch.serving import (
        ServingArtifact,
        export_adapt_serving,
        export_forward_serving,
        load_artifact,
        save_artifact,
    )

    dev = torch.device(device)
    kw = dict(model_kw or {"channels": (32, 64, 128, 256, 512), "strides": (2, 2, 2, 2), "num_res_units": 2,
                           "dtype": torch.bfloat16})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def new_model(arch=kw):
        return UNet3D(in_channels=2, num_classes=1, **arch, device=dev, seed=11)

    # the other methods' model: the first SERVING_METHODS_LEVELS levels; its
    # norm calls a forward are its norm modules
    methods_kw = dict(kw, channels=tuple(kw["channels"][:SERVING_METHODS_LEVELS]),
                      strides=tuple(kw["strides"][:SERVING_METHODS_LEVELS - 1]))
    methods_per_forward = sum(isinstance(m, InstanceNorm) for m in new_model(methods_kw).modules())

    def median(xs):
        return statistics.median(xs[1:] if len(xs) > 1 else xs)

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def profiled(fn) -> tuple:
        """One call of ``fn`` under ``torch.profiler`` (its summed kernel time,
        ms, and the host calls that took the most host time: ms, calls), and
        one under ``cProfile`` (the Python functions that took the most time
        of their own: ms, calls)."""
        import cProfile
        import pstats

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = prof.key_averages()
        device = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        host = sorted(((e.key, round(e.self_cpu_time_total / 1e3, 3), e.count) for e in events),
                      key=lambda r: -r[1])[:6]
        py = cProfile.Profile()
        py.enable()
        fn()
        sync()
        py.disable()
        stats = pstats.Stats(py).stats
        python = sorted(((f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", round(v[2] * 1e3, 3), v[1])
                         for k, v in stats.items()), key=lambda r: -r[1])[:8]
        return device, host, python

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n_batches = max(n for *_, n in runs)
    vols = hecktor_volumes(n_batches * batch, seed=19, shape=tuple(shape))
    images = [torch.from_numpy(np.stack([v["image"] for v in vols[i * batch:(i + 1) * batch]]))
              for i in range(n_batches)]
    image_shape = (batch, *shape, 2)
    out = {"device": str(dev), "image": list(image_shape), "runs": {}}

    def export(tag, overrides, to_file: bool, arch=kw, per=per_forward):
        """One method's artifact of ``new_model(arch)`` (``per`` norm
        calls a forward): through its file (Tent's two), or the exported
        program as it is (the other methods, to keep the phase short)."""
        cfg = compose(CONFIG_DIR, "config", tta_overrides(*overrides))
        cls = get_tta_method(str(cfg.tta.method))
        mode = str(cfg.tta.predict).lower()
        ad = cls(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        t0 = time.perf_counter()
        program, meta, state0 = export_adapt_serving(ad, new_model(arch), image_shape, threshold=THRESHOLD,
                                                     predict_mode=mode, device=dev)
        sync()
        rec = {"mode": mode, "episodic": meta["episodic"], "steps": meta["steps"],
               "export_s": time.perf_counter() - t0, "n_state": len(state0), "arch": arch,
               "want": artifact_launches(ad, mode, per)}
        if to_file:
            path = os.path.join(root, f"{tag}.mttap")
            t0 = time.perf_counter()
            save_artifact(path, program, meta, state0)
            rec["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            art = load_artifact(path, device=dev)
            rec["load_s"] = time.perf_counter() - t0
            rec["bytes"] = os.path.getsize(path)
            state0 = art.initial_state()
        else:
            art = ServingArtifact(program, meta, b"", dev)
        rec["program_norm_calls"] = program_norm_calls(art)
        live = cls(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        return ad, art, meta, state0, live, rec

    def serve(ad, art, meta, state0, live, rec, n):
        live_model = new_model(rec["arch"])
        fn = live.make_adapt_predict_fn(live_model, THRESHOLD, rec["mode"])
        gen = torch.Generator(device=dev).manual_seed(5)
        state = state0
        art_ms, live_ms, launches, live_launches, agree, ent_err, ents = [], [], [], [], [], [], []
        for i in range(n):
            x = images[i].to(dev)
            draws = art.draws(gen, batch)
            live.batch_draws = lambda *a, _d=draws, **k: group_draws(meta["draws"], _d)
            sync()
            reset_counts()
            t0 = time.perf_counter()
            res = art.call(*(state0 if meta["episodic"] else state), x, *draws, batch, float("nan"))
            sync()
            art_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(read_counts())
            state = list(res[:art.n_state])
            reset_counts()
            t0 = time.perf_counter()
            _, live_pred = fn(live_model, x, batch)
            sync()
            live_ms.append((time.perf_counter() - t0) * 1e3)
            live_launches.append(read_counts())
            agree.append(1.0 - int((res[art.n_state + 1] != live_pred).sum()) / live_pred.numel())
            ent_err.append(float((res[art.n_state] - live._last_ents).abs().max()))
            ents.append([float(e) for e in res[art.n_state]])
        names = [a["name"] for a in meta["args"][:art.n_state]]
        got = dict(zip(names, state))
        want = dict(live_model.named_parameters())
        src = dict(zip(ad._names, ad._source))
        d_art = torch.cat([(got[f"param:{k}"] - s).flatten() for k, s in src.items()])
        d_live = torch.cat([(want[k].detach() - s).flatten() for k, s in src.items()])
        frozen_equal = all(torch.equal(got[f"param:{k}"], p.detach()) for k, p in want.items() if k not in src)
        rec.update({"batches": n, "art_ms": art_ms, "live_ms": live_ms, "art_median_ms": median(art_ms),
                    "live_median_ms": median(live_ms), "launches": launches, "live_launches": live_launches,
                    "pred_agree": agree, "ent_abs_err": ent_err, "entropy": ents,
                    "delta_rel_l2": float((d_art - d_live).norm() / d_live.norm().clamp_min(1e-30)),
                    "delta_norm": float(d_live.norm()), "frozen_equal": frozen_equal})
        if dev.type == "cuda":
            # one more call of each under the profiler, after the comparison
            # (the live step adapts its model again): the device time of a step
            rec["art_device_ms"], rec["art_host_top"], rec["art_python_top"] = profiled(
                lambda: art.call(*(state0 if meta["episodic"] else state), x, *draws, batch, float("nan")))
            rec["live_device_ms"], rec["live_host_top"], rec["live_python_top"] = profiled(
                lambda: fn(live_model, x, batch))
            # the artifact's ms per call with Python's cyclic collector on and off:
            # a long-lived process holds many tracked objects for it to walk
            rec["gc_tracked_objects"] = len(gc.get_objects())
            # other Python threads of the process contend for the interpreter lock that each
            # replayed operator call takes
            rec["threads"] = sorted(t.name for t in threading.enumerate())
            for tag in ("art_ms_gc_on", "art_ms_gc_off"):
                if tag == "art_ms_gc_off":
                    gc.disable()
                try:
                    rec[tag] = [timed(lambda: art.call(*(state0 if meta["episodic"] else state), x, *draws,
                                                       batch, float("nan"))) for _ in range(3)]
                finally:
                    gc.enable()
        bad = (min(agree) < ARTIFACT_PRED_AGREE or max(ent_err) > ARTIFACT_ENT_ABS
               or not rec["delta_rel_l2"] <= ARTIFACT_DELTA_REL or not rec["delta_norm"] > 0 or not frozen_equal
               or rec["program_norm_calls"] != rec["want"])
        if bad:
            raise AssertionError(f"artifact vs live step: {rec}")
        return rec

    for tag, overrides, n in runs:
        out["runs"][tag] = serve(*export(tag, overrides, True), n)
    for tag, overrides in methods:
        out["runs"][tag] = serve(*export(tag, overrides, False, methods_kw, methods_per_forward), 1)

    # the forward artifact against the evaluation forward
    cfg = compose(CONFIG_DIR, "config", tta_overrides("tta=tent"))
    strat = SegmentationEvaluationStrategy(cfg)
    model = new_model()

    def probs(image):
        return strat._probs_fn(model)(image)[1]

    path = os.path.join(root, "forward.mttap")
    t0 = time.perf_counter()
    program, meta = export_forward_serving(probs, image_shape, device=dev)
    save_artifact(path, program, meta)
    export_s = time.perf_counter() - t0
    art = load_artifact(path, device=dev)
    x = images[0].to(dev)
    fwd_ms, launches = [], []
    for _ in range(3):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        p_art = art.call(x)
        sync()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_counts())
    with torch.no_grad():
        live_ms = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            p_live = probs(x)
            sync()
            live_ms.append((time.perf_counter() - t0) * 1e3)
    err = float((p_art - p_live).abs().max())
    out["forward"] = {"export_s": export_s, "bytes": os.path.getsize(path), "max_abs_err": err,
                      "art_ms": fwd_ms, "live_ms": live_ms, "launches": launches,
                      "program_norm_calls": program_norm_calls(art), "want": {"forward": per_forward, "backward": 0}}
    if err > ARTIFACT_PROBS_ABS or out["forward"]["program_norm_calls"] != out["forward"]["want"]:
        raise AssertionError(f"forward artifact: {out['forward']}")
    del model, art

    if manifest is not None:
        art_path = os.path.join(root, "cli_tent.mttap")
        overrides = cli_overrides(manifest, os.path.join(root, "export_run"), "tta=tent", "tta.episodic=false",
                                  "tta.predict=inline", f"training.resume={best}", f"+export.batch_size={batch}",
                                  f"+export.path={art_path}", *cli_extra)
        reset_counts()
        t0 = time.perf_counter()
        export_serving.main(overrides, device=dev)
        sync()
        out["export_cli"] = {"wall_s": time.perf_counter() - t0, "bytes": os.path.getsize(art_path),
                             "launches": read_counts()}
        served = os.path.join(root, "served")
        reset_counts()
        t0 = time.perf_counter()
        rows = serve_artifact.main(["--artifact", art_path, "--manifest", manifest, "--channels", "ct_proc",
                                    "pt_proc", "--out", served, "--limit", str(SERVE_CASES),
                                    "--dispatch-deadline", "300"], device=dev)
        sync()
        wall = time.perf_counter() - t0
        with open(manifest, newline="", encoding="utf-8") as f:
            sources = {r["patient_id"]: r for r in csv.DictReader(f)}
        masks_ok = []
        for r in rows:
            img = nifti.load(os.path.join(served, r["files"]))
            src_affine, src_xyz = nifti.peek_canonical_geometry(sources[r["case_id"]]["ct_proc"])
            masks_ok.append(img.dataobj.dtype == np.uint8 and tuple(img.shape) == tuple(src_xyz)
                            and bool(np.allclose(img.affine, src_affine)))
        with open(os.path.join(served, "predictions.csv"), newline="", encoding="utf-8") as f:
            written = list(csv.DictReader(f))
        out["serve_cli"] = {"wall_s": wall, "cases": len(rows), "launches": read_counts(),
                            "statuses": [r["status"] for r in rows], "masks_in_source_grid": masks_ok,
                            "manifest_rows": len(written), "entropy_final": [r["entropy_final"] for r in rows]}
        if (len(rows) != SERVE_CASES or any(r["status"] != "ok" for r in rows) or not all(masks_ok)
                or len(written) != SERVE_CASES):
            raise AssertionError(f"cli.serve_artifact: {out['serve_cli']}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 20: the training options ----------------------------------------
OPTION_TRAIN_VOLUMES, OPTION_VAL_VOLUMES = 16, 4  # phase 11's: 2 steps of batch 8 an epoch
OPTION_EXPERTS = 8
# the runs of phase 20: (tag, model family, the recipe's overrides, what the
# training node gains). A: UNETR with 8 experts in blocks 1, 3, .., 11 and
# remat, once with Adam and once with the stock adafactor block; B: the
# flagship with deep supervision 2; C: UNet3D-WS under the flagship teacher
# (phase 11's checkpoint), focus all and uncertain; D: the flagship's
# bottleneck MoE (profiled at steps 1-2)
OPTION_RUNS = (
    ("A_unetr_moe8_adam", "unetr", ["model=unetr", f"model.moe_experts={OPTION_EXPERTS}", "training.remat=true"], {}),
    ("A_unetr_moe8_adafactor", "unetr", ["model=unetr", f"model.moe_experts={OPTION_EXPERTS}", "training.remat=true",
                                         "training.optimizer=adafactor"], {}),
    ("B_unet_deep_supervision2", "unet", ["model=unet", "model.deep_supervision=2"], {}),
    ("C_unet_ws_distill_all", "unet_ws", ["model=unet", "model.name=unet_ws"], {"focus": "all"}),
    ("C_unet_ws_distill_uncertain", "unet_ws", ["model=unet", "model.name=unet_ws"], {"focus": "uncertain"}),
    ("D_unet_moe8", "unet", ["model=unet", f"model.moe_experts={OPTION_EXPERTS}"], {"profile": True}),
)
# norm calls of one forward: the flagship 18, UNet3D-WS 16, UNETR 16
OPTION_NORMS = {"unet": 18, "unet_ws": 16, "unetr": 16}
# the f32 step, kernel vs plain norm: a small input the patch grid divides
OPTION_SMALL = {"unet": (16, 32, 32), "unet_ws": (16, 32, 32), "unetr": (32, 64, 64)}
PROFILE_STEPS = (1, 2)  # training.profile: start_step, num_steps


def option_overrides(*extra: str) -> list:
    """The HECKTOR21 recipe of configs/ (2 epochs, poly, validation with
    surface metrics every epoch, seed 0), then ``extra``."""
    return ["task=hecktor21", "dataset=hecktor21", "task.seed=0", "training.epochs=2", "training.scheduler.name=poly",
            "training.eval_test.every_n_epochs=1", "evaluation.surface.enable=true",
            f"evaluation.surface.nsd_tol={NSD_TOL}", *extra]


def option_config(tag: str, shape, teacher: str, root: str, extra=(), teacher_extra=()) -> dict:
    """The composed config of run ``tag`` of ``OPTION_RUNS``: the recipe,
    the run's overrides, ``extra``; the distillation node (the flagship
    ``model=unet`` node, composed with ``teacher_extra``, as the teacher;
    ``teacher`` the extension-less checkpoint) and the profiler node."""
    from multimodal_tta_tpu_torch.conf import compose

    _, family, overrides, node = dict((r[0], r) for r in OPTION_RUNS)[tag]
    configs = os.path.join(REPO, "configs")
    size = "training.data.transforms.image_size=[" + ",".join(map(str, shape)) + "]"
    run_dir = os.path.join(root, tag)
    cfg = compose(configs, "config", option_overrides(*overrides, size, f"task.save_dir={run_dir}",
                                                      f"hydra.run.dir={run_dir}", *extra)).to_container()
    if "focus" in node:
        flagship = compose(configs, "config", option_overrides("model=unet", *teacher_extra)).to_container()["model"]
        cfg["training"]["distill"] = {"enabled": True, "checkpoint": teacher, "temperature": 2.0, "weight": 1.0,
                                      "focus": node["focus"], "model": flagship}
    if node.get("profile"):
        cfg["training"]["profile"] = {"enabled": True, "start_step": PROFILE_STEPS[0], "num_steps": PROFILE_STEPS[1],
                                      "log_dir": os.path.join(run_dir, "profile")}
    return cfg


def routing_of(model, fn) -> list:
    """The top-1 expert of every token at each MoE layer while ``fn()``
    runs: each layer's first call (a remat recompute calls it again)."""
    import torch
    import torch.nn.functional as F

    from multimodal_tta_tpu_torch.models.moe import MoEMlp, route

    got, handles = {}, []
    for name, m in model.named_modules():
        if isinstance(m, MoEMlp):
            def hook(mod, args, name=name):
                if name not in got:
                    with torch.no_grad():
                        gates = torch.softmax(F.linear(args[0].float(), mod.router.weight, mod.router.bias), -1)
                        got[name] = route(gates, 1)[1].flatten()
            handles.append(m.register_forward_pre_hook(hook))
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return [got[k] for k in sorted(got)]


def share_alike(a: list, b: list) -> float:
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / max(sum(x.numel() for x in a), 1)


def training_options_phase(device, root: str, teacher: str, *, shape=SHAPE[:3], small=None, extra=None,
                           teacher_extra=(), runs=None, reset_counts=lambda: None, read_counts=lambda: {},
                           warm_steps: int = 4) -> dict:
    """Phase 20: the training options through ``ExperimentManager`` with the
    HECKTOR21 recipe at batch 8 (``OPTION_RUNS``): 2 epochs of
    ``OPTION_TRAIN_VOLUMES`` synthetic volumes of ``shape``, validation of
    ``OPTION_VAL_VOLUMES`` (surface metrics) each epoch; per run the warm
    step's ms on device batches, volumes/s, peak memory and the optimizer
    state's bytes; the MoE aux and dropped share of every step; for the MoE
    runs the share of tokens routed alike by a bf16 forward through the
    kernel and through the plain norm; one f32 step per run on a ``small``
    input, kernel vs plain norm; the profiler's trace of D; then
    ``training.debug_nans`` on B's model: two clean steps (strict mode)
    bitwise the flag-off steps, and timed, then a batch with a NaN raises
    ``FloatingPointError``.
    ``extra`` maps a family to overrides (the CPU test's narrow widths).

    Checks what holds on any device: finite losses; every trainable tensor
    moved; the teacher bitwise its checkpoint; each step's launches and the
    run's exactly as ``OPTION_NORMS``, ``remat_norms`` and the teacher's
    forward derive them; each validation EDT bitwise its plain version; the
    f32 step's loss and deltas (phase 12's limits); the trace's
    ``ProfilerStep``s; the NaN checks. The caller holds the numbers."""
    import gc
    import shutil
    import statistics

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.data import HostLoader, get_seg_transforms
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.models.layers import set_plain_norm
    from multimodal_tta_tpu_torch.registry import get_model
    from multimodal_tta_tpu_torch.utils.metrics import set_random_seed

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    extra = extra or {}
    small = small or OPTION_SMALL

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    shutil.rmtree(root, ignore_errors=True)
    out: dict = {"runs": {}}
    train_set = hecktor_volumes(OPTION_TRAIN_VOLUMES, 61, shape)
    val_set = hecktor_volumes(OPTION_VAL_VOLUMES, 62, shape)
    spec = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                              image_size=list(shape), intensity_policy=HECKTOR_POLICY,
                              channel_names=["ct", "pt"], on_device=True).device_spec()
    teacher_sd = saved_state_dict(teacher)

    class StepRecorder(HookBase):
        def __init__(self):
            self.launches, self.losses, self.ms, self.moe = [], [], [], []

        def before_train_step(self):
            sync()
            self._at, self._t = read_counts(), time.perf_counter()

        def after_train_step(self):
            sync()
            self.ms.append((time.perf_counter() - self._t) * 1e3)
            got = read_counts()
            self.launches.append({k: got[k] - self._at[k] for k in got})
            self.losses.append(self.trainer._pending_loss)
            if self.trainer.moe_stats is not None:
                self.moe.append({k: [float(v) for v in t] for k, t in self.trainer.moe_stats.items()})

    def run_one(tag: str, family: str, node: dict) -> dict:
        """One run of ``OPTION_RUNS``: its numbers; every tensor it made is
        freed when it returns, so the next run's peak memory is its own."""
        t_run = time.perf_counter()
        cfg = option_config(tag, shape, teacher, root, extra.get(family, ()), teacher_extra)
        batch = int(cfg["training"]["batch_size"])
        m = ExperimentManager(ConfigNode(cfg), device=dev)
        model = m.setup_model()
        m.setup_optimizer()
        m.setup_scheduler()
        m.train_loader = HostLoader(train_set, batch_size=batch, shuffle=True, drop_last=True, num_workers=2, seed=0)
        m.val_loader = HostLoader(val_set, batch_size=int(cfg["training"]["eval_batch_size"]), num_workers=2)
        m.device_transform = spec
        m.setup_trainer()
        trainer = m.trainer
        trainer._hooks.remove(m.checkpoint_hook)  # phase 11 checks the checkpoints; no 3 GB writes here
        rec = StepRecorder()
        trainer.register_hooks([rec])
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        per_forward = OPTION_NORMS[family]
        recompute = remat_norms(model) if family == "unetr" else 0
        teacher_fwd = OPTION_NORMS["unet"] if "focus" in node else 0
        val_edt = []

        def recording_edt(pts, spacing, *, sqrt=False):
            got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
            val_edt.append((pts.clone(), spacing, sqrt, got.clone()))
            return got

        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        surface_module.squared_edt_volumes = recording_edt
        reset_counts()
        t0 = time.perf_counter()
        try:
            history = m.train(2)
            sync()
        finally:
            surface_module.squared_edt_volumes = squared_edt_volumes
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        losses = [float(v) for v in rec.losses]
        unmoved = sorted(n for n, p in model.named_parameters() if torch.equal(p, params0[n]))
        n_steps, n_val = len(losses), 2 * len(m.val_loader)
        step_want = {"forward": per_forward + recompute + teacher_fwd, "backward": per_forward}
        run_want = {"forward": n_steps * step_want["forward"] + n_val * per_forward,
                    "backward": n_steps * per_forward, "minplus": n_val}
        edt = [torch.equal(got, squared_edt_volumes_plain(pts, spacing, sqrt=root_))
               for pts, spacing, root_, got in val_edt]
        del val_edt
        r = {"family": family, "params": len(params0), "param_count": sum(p.numel() for p in params0.values()),
             "wall_s": wall, "losses": losses, "step_ms": rec.ms, "step_launches": rec.launches, "launches": counts,
             "want": run_want, "step_want": step_want, "unmoved": unmoved, "moe": rec.moe, "peak_gib": peak / 2**30,
             "optimizer": type(getattr(trainer.state.optimizer, "optimizer", trainer.state.optimizer)).__name__,
             "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]],
             "edt_bitwise": edt, "steps": n_steps, "val_batches": n_val, "batch": batch}
        if n_steps != 2 * (OPTION_TRAIN_VOLUMES // batch) or not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: {n_steps} steps, losses {losses}")
        if unmoved:
            raise AssertionError(f"{tag}: training left {unmoved} unmoved")
        if not all(_counted(s, step_want) for s in rec.launches) or not _counted(counts, run_want):
            raise AssertionError(f"{tag}: launches {rec.launches} / {counts}, derived {step_want} / {run_want}")
        if len(edt) != n_val or not all(edt):
            raise AssertionError(f"{tag}: validation EDT bitwise {edt}")
        for ev in history["eval_history"]:
            bad = {k: v for k, v in ev.items() if not math.isfinite(float(v))}
            if bad or "gtvt_hd95" not in ev:
                raise AssertionError(f"{tag} validation: {bad or sorted(ev)}")
        if int(cfg["model"].get("moe_experts") or 0) > 0:
            n_layers = sum(1 for n in model.state_dict() if n.endswith(".router.weight"))
            if len(rec.moe) != n_steps or any(len(s["aux"]) != n_layers for s in rec.moe):
                raise AssertionError(f"{tag}: MoE stats {rec.moe}, {n_layers} layers")
            r["moe_layers"] = n_layers
        if trainer.teacher is not None:
            tsd = trainer.teacher.state_dict()
            r["teacher_bitwise_checkpoint"] = tsd.keys() == teacher_sd.keys() and all(
                torch.equal(tsd[k].cpu(), v) for k, v in teacher_sd.items())
            if not r["teacher_bitwise_checkpoint"] or any(p.requires_grad for p in trainer.teacher.parameters()):
                raise AssertionError(f"{tag}: the teacher moved or is trainable")
        if node.get("profile"):
            hook = m.profiler_hook
            with open(hook.trace_path) as f:
                trace = json.load(f)["traceEvents"]
            names = {str(e.get("name", "")) for e in trace}
            steps_ = sorted(n for n in names if n.startswith("ProfilerStep#"))
            kernels = sorted({k for n in names for k in re.findall(r"in_(?:fwd|bwd)_(?:resident|stream)", n)})
            r["profile"] = {"trace": os.path.relpath(hook.trace_path, root), "bytes": os.path.getsize(hook.trace_path),
                            "profiler_steps": steps_, "norm_kernels": kernels, "events": len(trace)}
            if len(steps_) != PROFILE_STEPS[1] or (cuda and {k[:6] for k in kernels} != {"in_fwd", "in_bwd"}):
                raise AssertionError(f"{tag}: the trace holds {steps_} and norm kernels {kernels}")

        # warm steps on device-resident batches: ms a step, volumes/s, peak memory
        dev_batches = [{"image": torch.from_numpy(np.stack([v["image"] for v in train_set[k:k + batch]])).to(dev),
                        "label": torch.from_numpy(np.stack([v["label"] for v in train_set[k:k + batch]])).to(dev),
                        "_n_valid": batch} for k in (0, batch)]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        warm = []
        for i in range(warm_steps):
            sync()
            t0 = time.perf_counter()
            trainer.run_step(dev_batches[i % 2])
            sync()
            warm.append((time.perf_counter() - t0) * 1e3)
        trainer.flush_step_metrics()
        med = statistics.median(warm[1:])
        opt = trainer.state.optimizer
        r.update(warm_step_ms=warm, median_step_ms=med, volumes_per_s=batch * 1e3 / med,
                 warm_peak_gib=(torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30,
                 optimizer_state_bytes=sum(t.numel() * t.element_size()
                                           for st in getattr(opt, "optimizer", opt).state.values()
                                           for t in st.values() if torch.is_tensor(t)))
        if "moe_layers" in r:  # a bf16 forward through the kernel and through the plain norm
            x = dev_batches[0]["image"][:2].float()
            x = trainer._norm_fn(x) if trainer._norm_fn is not None else x
            routes = {}
            with torch.no_grad():
                for plain in (False, True):
                    set_plain_norm(model, plain)
                    routes[plain] = routing_of(model, lambda: model(x))
            set_plain_norm(model, False)
            r["bf16_routed_alike"] = share_alike(routes[False], routes[True])
        del dev_batches
        trainer.state.optimizer.zero_grad(set_to_none=True)
        del trainer, model, m, rec, params0
        if cuda:
            torch.cuda.empty_cache()

        # one f32 step on a small input, kernel vs plain norm (phase 12's limits)
        sm = small[family]
        cfg32 = option_config(tag, sm, teacher, root, extra.get(family, ()), teacher_extra)
        cfg32["training"].update(compute_dtype="float32", optimizer="sgd",
                                 optimizers={"sgd": {"lr": 1e-2, "momentum": 0.9}}, profile={"enabled": False})
        rs = np.random.RandomState(23)
        small_batch = {"image": np.stack([np.stack([rs.randn(*sm) * 200.0 - 100.0, np.abs(rs.randn(*sm)) * 3.0],
                                                   axis=-1) for _ in range(2)]).astype(np.float32),
                       "label": (rs.rand(2, *sm, 1) > 0.9).astype(np.float32)}
        parity, routed = {}, {}
        for plain in (False, True):
            sized = {"image_size": list(sm)} if family == "unetr" else {}
            mm = get_model(family).from_config(ConfigNode(cfg32["model"]), dtype=torch.float32,
                                               remat=cfg32["training"].get("remat", False), device=dev, seed=5,
                                               **sized)
            set_plain_norm(mm, plain)
            tr = SegTrainer(ConfigNode(cfg32), device_transform=spec, device=dev)
            tr.setup(TrainState(model=mm, optimizer=build_optimizer(ConfigNode(cfg32["training"]), mm)[0]))
            tr.prepare()
            if tr.teacher is not None:
                set_plain_norm(tr.teacher, plain)
            src = {n: p.detach().clone() for n, p in mm.named_parameters()}
            reset_counts()
            routed[plain] = routing_of(mm, lambda: tr.run_step(small_batch))
            loss = tr.flush_step_metrics()["loss"]
            sync()
            ran = read_counts()
            parity[plain] = (loss, {n: (p.detach() - src[n]).flatten() for n, p in mm.named_parameters()},
                             {k: ran.get(k, 0) for k in ("forward", "backward")})
            del mm, tr
        (l_k, d_k, ran_k), (l_p, d_p, ran_p) = parity[False], parity[True]
        dk, dp = torch.cat(list(d_k.values())), torch.cat(list(d_p.values()))
        off = sorted(((float((d_k[n] - d_p[n]).norm()), n) for n in d_p), reverse=True)[:3]
        f32 = {"shape": [2, *sm, 2], "loss": (l_k, l_p), "loss_rel": abs(l_k - l_p) / abs(l_p),
               "delta_rel_l2": float((dk - dp).norm() / dp.norm()), "launches": (ran_k, ran_p),
               "most_apart": [(n, d / float(dp.norm())) for d, n in off]}
        if routed[False]:
            f32["routed_alike"] = share_alike(routed[False], routed[True])
        r["f32_step"] = f32
        del parity, d_k, d_p, dk, dp, routed  # params-sized: the next run's peak memory is its own
        if not (f32["loss_rel"] <= TRAIN_LOSS_REL and f32["delta_rel_l2"] <= TRAIN_DELTA_REL):
            raise AssertionError(f"{tag}: the f32 step through the kernel disagrees with the plain norm: {f32}")
        if cuda and (ran_k != {"forward": step_want["forward"], "backward": per_forward}
                     or ran_p != {"forward": 0, "backward": 0}):
            raise AssertionError(f"{tag}: f32 parity launches {ran_k} / {ran_p}, derived {step_want}")
        r["run_s"] = time.perf_counter() - t_run
        return r

    for tag, family, _, node in (OPTION_RUNS if runs is None else [r for r in OPTION_RUNS if r[0] in runs]):
        out["runs"][tag] = run_one(tag, family, node)
        gc.collect()  # a trainer and its hooks refer to each other
        if cuda:
            torch.cuda.empty_cache()

    # training.debug_nans on B's model: clean steps in strict mode, bitwise
    # the flag-off steps; then a batch with a NaN raises FloatingPointError
    if runs is None or "debug_nans" in runs:
        tag = "B_unet_deep_supervision2"
        fam = "unet"
        clean = {"image": np.stack([v["image"] for v in train_set[:2]]),
                 "label": np.stack([v["label"] for v in train_set[:2]])}
        got, step_ms = {}, {}
        set_random_seed(0, "strict")
        try:
            for flag in (False, True):
                cfg = option_config(tag, shape, teacher, root, extra.get(fam, ()), teacher_extra)
                cfg["training"]["debug_nans"] = flag
                m = ExperimentManager(ConfigNode(cfg), device=dev)
                m.setup_model()
                m.setup_optimizer()
                m.device_transform = spec
                m.setup_trainer()
                step_ms[flag] = []
                for _ in range(2):  # the second step's time: what the checks cost a warm step
                    sync()
                    t0 = time.perf_counter()
                    m.trainer.run_step(clean)
                    sync()
                    step_ms[flag].append((time.perf_counter() - t0) * 1e3)
                got[flag] = (m.trainer.flush_step_metrics()["loss"],
                             {n: p.detach().clone() for n, p in m.model.named_parameters()})
            sync()
        finally:
            set_random_seed(0, "practical")
        bitwise = got[True][0] == got[False][0] and all(torch.equal(p, got[False][1][n])
                                                        for n, p in got[True][1].items())
        nan_batch = {k: v.copy() for k, v in clean.items()}
        nan_batch["image"][1, 5, 7, 9, 1] = np.nan
        try:
            m.trainer.run_step(nan_batch)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        out["debug_nans"] = {"clean_steps_bitwise_flag_off": bitwise, "loss": got[True][0], "raised": raised,
                             "step_ms": {"off": step_ms[False], "on": step_ms[True]}, "batch": 2}
        if not bitwise or raised is None:
            raise AssertionError(f"debug_nans: {out['debug_nans']}")
        del m, got
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 21: preprocessing on the card, from raw NIfTI into training and Tent
# HECKTOR 2021's grids (CT 512x512 at 0.977 mm in 3 mm slices, int16 HU; PET
# 200x200 at 4.07 mm, f32) and the stock preprocessing config
# (scripts/configs/hecktor21.yaml: [1, 1, 3] mm, [144, 144, 48], a 144 mm
# bbox): 6 raw cases over two source centres and one target centre, written
# uncompressed (through the config's suffix keys) so that the phase's time
# goes to the preprocessing and not to writing its input
PREP_CT = ((512, 512, 128), (0.977, 0.977, 3.0))
PREP_PT = ((200, 200, 128), (4.07, 4.07, 3.0))
PREP_CENTERS = {"CHGJ": 2, "CHUS": 2, "CHUP": 2}
PREP_TARGET = "CHUP"
PREP_BBOX_MM = 144.0
PREP_SPACING = (1.0, 1.0, 3.0)
PREP_OUTPUT = (144, 144, 48)
PREP_SUFFIX = ".nii"
PREP_NORMS = 18  # norm calls of one forward of the flagship UNet3D that cli.train and cli.adapt build
# BraTS 2023's grid (240x240x155 at 1 mm: four int16 modalities and the seg,
# gzip level 1) to scripts/configs/brats.yaml's [160, 192, 160]
PREP_BRATS_SHAPE = (240, 240, 155)
PREP_BRATS_CASES = 2
PREP_BRATS_OUTPUT = (160, 192, 160)
PREP_LINEAR_REL = 1e-5  # linear images, card vs CPU, of the data's range (tests/test_torch_resample.py)
UNUSED_OPS_REL = 1e-5  # SSIM, MS-SSIM, the losses and their gradients: card (TF32 off) vs CPU, relative
MOG_REL_L2 = 1e-4  # vae_delta_mog's f32 outputs: card (TF32 off) vs CPU, relative L2


def _ras_affine(origin, spacing):
    """The NIfTI RAS affine of an ITK (LPS) grid with the identity direction,
    as a DICOM-converted scan has: x and y negated."""
    import numpy as np

    aff = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    aff[:3, 3] = [-origin[0], -origin[1], origin[2]]
    return aff


def _ellipsoid(origin, spacing, shape, centre, radii):
    """The voxels of a grid (2D or 3D, LPS, identity direction) whose
    centres lie in an ellipse or ellipsoid, computed in its bounding box."""
    import numpy as np

    d = [((o + s * np.arange(n) - c) / r) ** 2 for o, s, n, c, r in zip(origin, spacing, shape, centre, radii)]
    out = np.zeros(tuple(shape), bool)
    hits = [np.nonzero(di <= 1.0)[0] for di in d]
    if all(len(h) for h in hits):
        box = tuple(slice(h[0], h[-1] + 1) for h in hits)
        total = sum(di[b].reshape([-1 if j == i else 1 for j in range(len(d))])
                    for i, (di, b) in enumerate(zip(d, box)))
        out[box] = total <= 1.0
    return out


def write_raw_hecktor(root: str, *, ct=PREP_CT, pt=PREP_PT, centers=PREP_CENTERS,
                      bbox_mm: float = PREP_BBOX_MM) -> dict:
    """A raw HECKTOR21-like tree from seed 0: per case a CT (int16 HU: air,
    a body ellipse of soft tissue with noise, a lesion 120 HU brighter), a
    PET on its own grid and origin (f32: a body, a hot lesion), the GTVt on
    the CT grid (uint8), a bbox CSV row of a ``bbox_mm`` cube around the
    lesion in ITK LPS millimetres and an info CSV row. Returns the paths and
    the case ids."""
    import csv

    import numpy as np

    from multimodal_tta_tpu_torch.data import nifti

    nii = os.path.join(root, "hecktor_nii")
    os.makedirs(nii, exist_ok=True)
    r = np.random.RandomState(0)
    (cshape, csp), (pshape, psp) = ct, pt
    csp, psp = np.asarray(csp, np.float64), np.asarray(psp, np.float64)
    fov = np.asarray(cshape) * csp
    rows = {"bbox_csv": [], "info_csv": []}
    cases = []
    for cid, (center, n) in enumerate(centers.items()):
        for i in range(n):
            pid = f"{center}{i + 1:03d}"
            centre = r.uniform(-20.0, 20.0, 3)
            ct_origin = centre - csp * (np.asarray(cshape) - 1) / 2
            pt_origin = centre + r.uniform(-5.0, 5.0, 3) - psp * (np.asarray(pshape) - 1) / 2
            lesion, radii = centre + r.uniform(-0.12, 0.12, 3) * fov, r.uniform(0.03, 0.06, 3) * fov
            body = (0.4 * fov[0], 0.33 * fov[1])

            inside = _ellipsoid(ct_origin[:2], csp[:2], cshape[:2], centre[:2], body)
            ct_vol = np.where(inside, 40.0 + 25.0 * r.randn(*inside.shape), -1000.0).astype(np.float32)
            ct_vol = ct_vol[:, :, None] + (5.0 * r.randn(cshape[2])).astype(np.float32)
            gt = _ellipsoid(ct_origin, csp, cshape, lesion, radii)
            ct_vol[gt] += 120.0
            inside = _ellipsoid(pt_origin[:2], psp[:2], pshape[:2], centre[:2], body)
            pt_vol = np.where(inside, 1.0 + 0.2 * np.abs(r.randn(*inside.shape)), 0.05).astype(np.float32)
            pt_vol = pt_vol[:, :, None] * (1.0 + 0.01 * r.randn(pshape[2])).astype(np.float32)
            pt_vol[_ellipsoid(pt_origin, psp, pshape, lesion, radii)] += 8.0

            nifti.save(np.rint(ct_vol).astype(np.int16), _ras_affine(ct_origin, csp),
                       os.path.join(nii, f"{pid}_ct{PREP_SUFFIX}"))
            nifti.save(pt_vol, _ras_affine(pt_origin, psp), os.path.join(nii, f"{pid}_pt{PREP_SUFFIX}"))
            nifti.save(gt.astype(np.uint8), _ras_affine(ct_origin, csp),
                       os.path.join(nii, f"{pid}_gtvt{PREP_SUFFIX}"))
            box = {f"{a}{k}": float(c + s * bbox_mm / 2) for a, c in zip("xyz", lesion)
                   for k, s in ((1, -1), (2, 1))}
            rows["bbox_csv"].append({"PatientID": pid, **box})
            rows["info_csv"].append({"PatientID": pid, "CenterID": cid + 1})
            cases.append(pid)
    out = {"nii_root": nii, "cases": cases}
    for key, table in rows.items():
        out[key] = os.path.join(root, key.replace("_csv", ".csv"))
        with open(out[key], "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(table[0]))
            w.writeheader()
            w.writerows(table)
    return out


def hecktor_prep_config(raw: dict, out_root: str, *, spacing=PREP_SPACING, output=PREP_OUTPUT) -> dict:
    """scripts/configs/hecktor21.yaml's keys for the raw tree ``raw``: the
    stock geometry, pads and dtypes, the given spacing and size, one
    validation case per source centre, per-domain CSVs."""
    return {"bbox_csv": raw["bbox_csv"], "info_csv": raw["info_csv"], "nii_root": raw["nii_root"],
            "out_root": out_root, "out_manifest_csv": os.path.join(out_root, "manifest.csv"),
            "export_per_domain_csv": True, "target_spacing": list(spacing), "output_size": list(output),
            "pad_value_ct": -1024.0, "pad_value_pt": 0.0, "pad_value_mask": 0.0, "interp_ct": "linear",
            "interp_pt": "linear", "interp_mask": "nearest", "save_float_dtype": "float32",
            "save_mask_dtype": "uint8", "ct_suffix": f"_ct{PREP_SUFFIX}", "pt_suffix": f"_pt{PREP_SUFFIX}",
            "gt_suffix": f"_gtvt{PREP_SUFFIX}", "enable_split": True, "seed": 2026, "val_per_center": 1,
            "source_centers": [c for c in PREP_CENTERS if c != PREP_TARGET], "target_centers": [PREP_TARGET],
            "other_centers_policy": "ignore"}


def write_raw_brats(root: str, *, shape=PREP_BRATS_SHAPE, cases: int = PREP_BRATS_CASES) -> str:
    """A raw BraTS-layout tree from seed 0: per case four int16 modalities
    (integer intensities, as BraTS stores them: zero outside a brain
    ellipsoid, noise inside, a tumour of three nested regions) and the uint8
    seg (labels 1-3), 1 mm, ``.nii.gz`` at gzip level 1."""
    import gzip

    import numpy as np

    from multimodal_tta_tpu_torch.data import nifti

    r = np.random.RandomState(0)
    sp = np.ones(3)
    for i in range(cases):
        case = f"BraTS-GLI-{i:05d}-000"
        d = os.path.join(root, case)
        os.makedirs(d, exist_ok=True)
        origin = r.uniform(-10.0, 10.0, 3) - (np.asarray(shape) - 1) / 2
        brain = _ellipsoid(origin, sp, shape, (0.0, 0.0, 0.0), np.asarray(shape) * 0.4)
        centre = r.uniform(-20.0, 20.0, 3)
        regions = [_ellipsoid(origin, sp, shape, centre, np.full(3, rad)) for rad in (24.0, 14.0, 7.0)]
        seg = np.zeros(shape, np.uint8)
        for label, region in zip((2, 1, 3), regions):
            seg[region] = label
        vols = {}
        for m, (base, gain) in zip(("t1n", "t1c", "t2w", "t2f"), ((300, 80), (350, 200), (250, -60), (200, 150))):
            v = np.where(brain, base + 30.0 * r.randn(shape[0], shape[1], 1), 0.0) + gain * (seg > 0)
            vols[m] = np.rint(v).astype(np.int16)
        vols["seg"] = seg
        for m, v in vols.items():
            raw = os.path.join(d, f"{case}-{m}.nii")
            nifti.save(v, _ras_affine(origin, sp), raw)
            with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb", compresslevel=1) as g:
                g.write(f.read())
            os.remove(raw)
    return root


def _same_volumes(a: str, b: str) -> dict:
    """Two written volumes: affine and dtype equal, values' max abs error
    and the data's range."""
    import numpy as np

    from multimodal_tta_tpu_torch.data import nifti

    ia, ib = nifti.load(a), nifti.load(b)
    va, vb = np.asarray(ia.dataobj), np.asarray(ib.dataobj)
    return {"affine_equal": bool(np.array_equal(ia.affine, ib.affine)) and va.dtype == vb.dtype
            and va.shape == vb.shape,
            "max_abs_err": float(np.abs(va.astype(np.float64) - vb.astype(np.float64)).max()),
            "range": float(np.ptp(vb.astype(np.float64))), "equal": bool(np.array_equal(va, vb))}


def _check_volumes(pairs: dict, labels: tuple, what: str) -> dict:
    """Hold each volume of one device against the other's: labels equal,
    images within ``PREP_LINEAR_REL`` of their range, affines equal."""
    out = {name: _same_volumes(a, b) for name, (a, b) in pairs.items()}
    for name, r in out.items():
        ok = r["equal"] if name in labels else r["max_abs_err"] <= PREP_LINEAR_REL * r["range"]
        if not (ok and r["affine_equal"]):
            raise AssertionError(f"{what}: {name} card vs CPU {r}")
    return out


def _rows_equal_but_dirs(a: dict, b: dict) -> bool:
    """Manifest rows equal, output paths compared by file name."""
    def norm(row):
        return {k: os.path.basename(v) if k.endswith("_proc") else v for k, v in row.items()}

    return norm(a) == norm(b)


def unused_ops_phase(device, ct_path: str, pt_path: str, *, image2d=(64, 224, 224, 3), rot_batch=(8, 48, 144, 144, 2),
                     seg_batch=(2, 48, 144, 144, 1), embed=(64, 512, 8), mog=None, mog_batch: int = 64) -> dict:
    """Phase 21 (e): the ops nothing calls, on ``device`` against the CPU on
    the same inputs: SSIM and MS-SSIM of a prepared CT/PET pair (3D, with as
    many scales as its smallest side holds: three at 48 slices) and of a 2D
    pair, ``rand_rot90`` on a training batch (each of the four quarter-turn
    counts, bitwise), focal and triplet losses with their gradients, and
    ``vae_delta_mog``'s forward with the same weights and draws. Returns each
    comparison and its ms on ``device``."""
    import numpy as np
    import torch

    from multimodal_tta_tpu_torch.data import nifti
    from multimodal_tta_tpu_torch.models.mogvae import VAEDeltaMoG
    from multimodal_tta_tpu_torch.ops.augment import apply_rand_rot90
    from multimodal_tta_tpu_torch.ops.losses import focal_loss, triplet_margin_loss
    from multimodal_tta_tpu_torch.ops.ssim import ms_ssim, ssim

    dev, cpu = torch.device(device), torch.device("cpu")
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(21)
    out = {}

    def timed(fn):
        if not cuda:
            return fn(), None
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        return got, (time.perf_counter() - t0) * 1e3

    def rel(a, b) -> float:
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    def vol(path, lo, hi):  # a prepared volume [D, H, W] in [0, 1]
        v = np.asarray(nifti.load(path).dataobj, np.float32).transpose(2, 1, 0)
        return torch.from_numpy((np.clip(v, lo, hi) - lo) / (hi - lo))

    x3 = vol(ct_path, -1000.0, 1000.0)[None, ..., None]
    y3 = vol(pt_path, 0.0, 15.0)[None, ..., None]
    # as many of MS-SSIM's scales as the volume's smallest side holds (win 11)
    scales = max(s for s in range(1, 6) if min(x3.shape[1:4]) > 12 * 2 ** (s - 1) - 2)
    x2 = torch.rand(image2d, generator=g)
    y2 = (x2 + 0.1 * torch.randn(image2d, generator=g)).clamp(0, 1)
    cases = {"ssim_3d": (ssim, x3, y3, {}),
             "ms_ssim_3d": (ms_ssim, x3, y3, {"weights": (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)[:scales]}),
             "ssim_2d": (ssim, x2, y2, {}), "ms_ssim_2d": (ms_ssim, x2, y2, {})}
    for name, (fn, a, b, kw) in cases.items():
        want = fn(a, b, **kw)
        got, ms = timed(lambda: fn(a.to(dev), b.to(dev), **kw))
        out[name] = {"shape": list(a.shape), "value": float(got), "cpu": float(want), "rel": rel(got, want), "ms": ms}
        if not out[name]["rel"] <= UNUSED_OPS_REL:
            raise AssertionError(f"{name}: {out[name]}")

    image = torch.randn(rot_batch, generator=g)
    label = (torch.rand(rot_batch[:-1] + (1,), generator=g) > 0.5).float()
    k = torch.arange(rot_batch[0]) % 4  # each of the four branches
    want = apply_rand_rot90(image, label, k)
    got, ms = timed(lambda: apply_rand_rot90(image.to(dev), label.to(dev), k.to(dev)))
    out["rand_rot90"] = {"shape": list(rot_batch), "k": k.tolist(), "ms": ms,
                         "bitwise": all(torch.equal(a.cpu(), b) for a, b in zip(got, want))}
    if not out["rand_rot90"]["bitwise"]:
        raise AssertionError(f"rand_rot90: {out['rand_rot90']}")

    logits = torch.randn(seg_batch, generator=g) * 3
    target = (torch.rand(seg_batch, generator=g) > 0.8).float()
    n, width, classes = embed
    emb = torch.randn(n, width, generator=g)
    labels = torch.randint(0, classes, (n,), generator=g)
    for name, fn, args in (("focal_loss", focal_loss, (logits, target)),
                           ("triplet_margin_loss", triplet_margin_loss, (emb, labels))):
        def run(on):
            x = args[0].to(on).requires_grad_()
            value = fn(x, args[1].to(on))
            return value, torch.autograd.grad(value, x)[0]

        (want, want_g), ((got, got_g), ms) = run(cpu), timed(lambda: run(dev))
        out[name] = {"shape": list(args[0].shape), "value": float(got.detach()), "rel": rel(got, want),
                     "grad_rel": rel(got_g, want_g), "ms": ms}
        if not (out[name]["rel"] <= UNUSED_OPS_REL and out[name]["grad_rel"] <= UNUSED_OPS_REL):
            raise AssertionError(f"{name}: {out[name]}")

    m_cpu = VAEDeltaMoG(**(mog or {}), device="cpu", seed=0)
    m_dev = VAEDeltaMoG(**(mog or {}), device=dev, seed=None)
    m_dev.load_state_dict(m_cpu.state_dict())
    xm = torch.rand((mog_batch,) + m_cpu.image_size + (m_cpu.in_channels,), generator=g)
    eps = m_cpu.reparam_draws(mog_batch, g)
    with torch.no_grad():
        want = m_cpu(xm, *eps)
        got, ms = timed(lambda: m_dev(xm.to(dev), *(e.to(dev) for e in eps)))
    out["vae_delta_mog"] = {"input": list(xm.shape), "params": sum(p.numel() for p in m_cpu.parameters()),
                            "delta_rel_l2": rel(got[0], want[0]), "ms": ms,
                            "aux_rel_l2": {k: rel(got[1][k], want[1][k]) for k in want[1]}}
    worst = max([out["vae_delta_mog"]["delta_rel_l2"]] + list(out["vae_delta_mog"]["aux_rel_l2"].values()))
    if not worst <= MOG_REL_L2 or tuple(got[0].shape) != tuple(xm.shape[:3]) + (1,):
        raise AssertionError(f"vae_delta_mog: {out['vae_delta_mog']}")
    return out


def prep_overrides(manifest: str, run_dir: str, *extra: str) -> list:
    """``cli.train`` / ``cli.adapt`` on the prepared HECKTOR manifest: the
    full-width recipe of configs/, target centre ``PREP_TARGET``, one
    validation case per source centre, one epoch at batch 2 with validation
    (surface metrics on) and a checkpoint."""
    return ["task=hecktor21", "dataset=hecktor21", "model=unet", f"dataset.manifest_csv={manifest}",
            f"dataset.target_center={PREP_TARGET}", "dataset.val_per_center=1", "training.epochs=1",
            "training.batch_size=2", "training.eval_batch_size=2", "training.model_save_start=0",
            "training.model_save_freq=1", "evaluation.surface.enable=true",
            f"task.save_dir={os.path.dirname(run_dir)}", f"hydra.run.dir={run_dir}", *extra]


def preprocess_phase(device, root: str, *, ct=PREP_CT, pt=PREP_PT, bbox_mm: float = PREP_BBOX_MM,
                     spacing=PREP_SPACING, output=PREP_OUTPUT, brats_shape=PREP_BRATS_SHAPE,
                     brats_output=PREP_BRATS_OUTPUT, extra=(), ops_kw=None, reset_counts=lambda: None, read_counts=lambda: {}) -> dict:
    """Phase 21: raw NIfTI -> ``cli.prepare_hecktor21`` on ``device`` -> the
    prepared manifest through ``cli.train`` and ``cli.adapt`` with Tent.

    (a) writes the raw HECKTOR21 tree (``write_raw_hecktor``) and prepares it
    on ``device``: ms per case by part, cases/s, the resample's peak memory
    and its ms per CT; (b) prepares its first case again on the CPU and holds
    the device to it (labels equal, images within ``PREP_LINEAR_REL`` of their
    range, affines and the manifest row equal); (c) prepares a raw BraTS tree
    (``write_raw_brats``) on ``device`` and one case again on the CPU, held
    the same way; (d) ``cli.train`` (1 epoch, batch 2, validation with surface
    metrics) and ``cli.adapt`` (Tent, the no-adapt report) on the prepared
    manifest, their launches counted from 0 (``reset_counts`` /
    ``read_counts``) and each EDT recorded to be held bitwise against its
    plain version; (e) ``unused_ops_phase`` on the prepared CT/PET pair.
    ``extra`` is appended to (d)'s overrides. Returns every number; the
    caller holds (d)'s launches against ``out[...]["want"]``."""
    import shutil
    import statistics
    from pathlib import Path

    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.cli import adapt, prepare_brats, prepare_hecktor21, train
    from multimodal_tta_tpu_torch.conf import yaml_subset
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.data.csv_table import read_csv
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.ops.resample import resample_to_spacing

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def write_config(path: str, cfg: dict) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(yaml_subset.dump(cfg))
        return path

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out: dict = {"device": str(dev)}

    # (a) the raw HECKTOR21 tree, prepared on the device
    t0 = time.perf_counter()
    raw = write_raw_hecktor(os.path.join(root, "raw"), ct=ct, pt=pt, bbox_mm=bbox_mm)
    out["fixture_s"] = time.perf_counter() - t0
    out["fixture_bytes"] = sum(os.path.getsize(os.path.join(raw["nii_root"], n)) for n in os.listdir(raw["nii_root"]))
    cfg = hecktor_prep_config(raw, os.path.join(root, "hecktor21"), spacing=spacing, output=output)
    cfg_path = write_config(os.path.join(root, "hecktor21.yaml"), cfg)
    def peak_gib(base: int):
        """The peak allocated since ``reset_peak_memory_stats`` above what was
        allocated before (the phases before this one hold their own)."""
        return (torch.cuda.max_memory_allocated(dev) - base) / 2**30 if cuda else None

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    reset_counts()
    t0 = time.perf_counter()
    res = prepare_hecktor21.main(["--config", cfg_path], device=dev)
    wall = time.perf_counter() - t0
    rows, part_ms = res["rows"], res["part_ms"]
    if [r["patient_id"] for r in rows] != raw["cases"] or any(r["status"] != "ok" for r in rows):
        raise AssertionError(f"prepare_hecktor21: {[(r['patient_id'], r['status']) for r in rows]}")
    manifest = cfg["out_manifest_csv"]
    read_back = read_csv(manifest)
    domains = sorted(os.listdir(os.path.dirname(manifest)))
    if len(read_back) != len(rows) or not {"source.csv", "target.csv"} <= set(domains):
        raise AssertionError(f"manifest {len(read_back)} rows, files {domains}")
    out["hecktor"] = {
        "cases": len(rows), "wall_s": wall, "cases_per_s": len(rows) / wall,
        "launches": read_counts(), "peak_gib": peak_gib(base),
        "part_ms": part_ms,
        "mean_part_ms": {p: statistics.fmean(ms[p] for ms in part_ms.values()) for p in prepare_hecktor21.PARTS},
        "ct_resampled": rows[0]["ct_size_resampled"], "roi": rows[0]["roi_size_idx"],
        "splits": [r["split"] for r in read_back.rows]}
    # the resample alone: the first case's CT at full size, ms and peak
    ct_data, ct_grid = prepare_hecktor21.read_image(os.path.join(raw["nii_root"], f"{raw['cases'][0]}_ct{PREP_SUFFIX}"))
    ms = []
    for _ in range(3):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        sync()
        t0 = time.perf_counter()
        resampled, _ = resample_to_spacing(ct_data, ct_grid, spacing, default_value=-1024.0, device=dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["hecktor"]["ct_resample"] = {
        "input": list(ct_data.shape), "output": list(resampled.shape), "ms": ms, "median_ms": statistics.median(ms),
        "bytes_in_out": int(ct_data.nbytes + resampled.nbytes), "peak_gib": peak_gib(base)}
    del ct_data, resampled

    # (b) the first case again on the CPU
    pid = raw["cases"][0]
    bbox_row = next(r for r in read_csv(cfg["bbox_csv"]).rows if r["PatientID"] == pid)
    cpu_dir = os.path.join(root, "hecktor21_cpu")
    cpu_ms: dict = {}
    raw_paths = [os.path.join(raw["nii_root"], f"{pid}{cfg[k]}") for k in ("ct_suffix", "pt_suffix", "gt_suffix")]
    row_cpu = prepare_hecktor21.process_case(
        pid, bbox_row, prepare_hecktor21.geometry_config(cfg),
        (*(Path(p) for p in raw_paths), Path(cpu_dir, "images"), Path(cpu_dir, "labels")),
        device="cpu", part_ms=cpu_ms)
    row_dev = rows[0]
    out["hecktor"]["cpu_case"] = {
        "part_ms": cpu_ms, "row_equal": _rows_equal_but_dirs({k: row_dev[k] for k in row_cpu}, row_cpu),
        "volumes": _check_volumes({m: (row_dev[f"{m}_proc"], row_cpu[f"{m}_proc"]) for m in ("ct", "pt", "gtvt")},
                                  ("gtvt",), f"HECKTOR {pid}")}
    if not out["hecktor"]["cpu_case"]["row_equal"]:
        raise AssertionError(f"HECKTOR {pid}: the manifest rows of the card and the CPU differ")

    # (c) BraTS: two raw cases prepared on the device, one again on the CPU
    t0 = time.perf_counter()
    brats_raw = write_raw_brats(os.path.join(root, "brats_raw"), shape=brats_shape)
    fixture_s = time.perf_counter() - t0
    bcfg = {"raw_root": brats_raw, "out_root": os.path.join(root, "brats"), "modalities": ["t1n", "t1c", "t2w", "t2f"],
            "seg_suffix": "-seg.nii.gz", "target_spacing": [1.0, 1.0, 1.0], "output_size": list(brats_output),
            "pad_value_image": 0.0, "pad_value_mask": 0.0, "split_seed": 42, "split_ratios": [0.8, 0.1, 0.1]}
    bcfg_path = write_config(os.path.join(root, "brats.yaml"), bcfg)
    t0 = time.perf_counter()
    bres = prepare_brats.main(["--config", bcfg_path, "--workers", str(PREP_BRATS_CASES)], device=dev)
    bwall = time.perf_counter() - t0
    brows = bres["rows"]
    if len(brows) != 4 * PREP_BRATS_CASES or any(r["status"] != "ok" for r in brows):
        raise AssertionError(f"prepare_brats: {[(r['subject_id'], r['status']) for r in brows]}")
    case = brows[0]["subject_id"]
    # the first case again on the CPU, after the card's run: its voxels are
    # held to the card's. It writes each volume as .nii, without gzip: the
    # write is the same host code on both sides, and gzip level 9 of its
    # five noise volumes takes ~40 s (the card's ms by part hold that write)
    bcpu_ms: dict = {}
    bcpu_dir = os.path.join(root, "brats_cpu")
    os.makedirs(os.path.join(bcpu_dir, "images"))
    os.makedirs(os.path.join(bcpu_dir, "labels"))
    write_image = prepare_brats.write_image

    def unzipped(path):
        return str(path)[:-len(".gz")] if str(path).endswith(".gz") else str(path)

    prepare_brats.write_image = lambda path, *args: write_image(Path(unzipped(path)), *args)
    try:
        mod_rows, lab = prepare_brats.process_case(Path(brats_raw, case), bcfg, Path(bcpu_dir, "images"),
                                                   Path(bcpu_dir, "labels"), device="cpu", part_ms=bcpu_ms)
    finally:
        prepare_brats.write_image = write_image
    mod_rows, lab = [(m, unzipped(p)) for m, p in mod_rows], unzipped(lab)
    dev_paths = {r["modality"]: r["img_path"] for r in brows if r["subject_id"] == case}
    pairs = {m: (dev_paths[m], p) for m, p in mod_rows}
    pairs["seg"] = (brows[0]["label_path"], lab)
    out["brats"] = {"cases": PREP_BRATS_CASES, "fixture_s": fixture_s, "wall_s": bwall,
                    "cases_per_s": PREP_BRATS_CASES / bwall, "part_ms": bres["part_ms"], "cpu_part_ms": bcpu_ms,
                    "volumes": _check_volumes(pairs, ("seg",), f"BraTS {case}")}
    if sorted(os.path.basename(p) for p in dev_paths.values()) != sorted(os.path.basename(p) + ".gz"
                                                                     for _, p in mod_rows):
        raise AssertionError("BraTS: the card and the CPU wrote other files")

    # (d) the prepared manifest through cli.train and cli.adapt
    managers = []
    orig_setup_optimizer = ExperimentManager.setup_optimizer

    def setup_optimizer(self):
        managers.append(self)
        return orig_setup_optimizer(self)

    edt_in = []

    def recording_edt(pts, sp, *, sqrt=False):
        got = squared_edt_volumes(pts, sp, sqrt=sqrt)
        edt_in.append((pts.clone(), sp, sqrt, got.clone()))
        return got

    def run(cli, name: str, *args: str):
        run_dir = os.path.join(root, "runs", name)
        reset_counts()
        t0 = time.perf_counter()
        try:
            result = cli.main(prep_overrides(manifest, run_dir, *args, *extra), device=dev)
            sync()
        finally:
            os.chdir(REPO)  # the run moved into its run directory
        return result, run_dir, time.perf_counter() - t0, read_counts()

    ExperimentManager.setup_optimizer = setup_optimizer
    surface_module.squared_edt_volumes = recording_edt
    try:
        history, run_dir, wall, counts = run(train, "train")
        m = managers[-1]
        steps, n_val = len(m.train_loader), len(m.val_loader)
        losses = [h["loss"] for h in history["train_history"]]
        out["train"] = {"wall_s": wall, "launches": counts, "steps": steps, "val_batches": n_val,
                        "train_volumes": len(m.train_loader.dataset), "losses": losses,
                        "val": [{k: v for k, v in ev.items() if "/" not in k} for ev in history["eval_history"]],
                        "want": {"forward": PREP_NORMS * (steps + n_val), "backward": PREP_NORMS * steps,
                                 "minplus": n_val}}
        if not losses or not all(np.isfinite(losses)) or not history["eval_history"]:
            raise AssertionError(f"cli.train on the prepared manifest: {out['train']}")
        best = os.path.join(run_dir, "checkpoints", "best_model")
        results, run_dir, wall, counts = run(adapt, "adapt", "tta=tent", "tta.steps=1", "tta.report_no_adapt=true",
                                             f"training.resume={best}")
        b = len(managers[-1].test_loader)
        out["adapt"] = {"wall_s": wall, "launches": counts, "test_batches": b, "target": PREP_TARGET,
                        "metrics": {mode: {k: v for k, v in r.items() if "/" not in k} for mode, r in results.items()},
                        "want": {"forward": 3 * PREP_NORMS * b, "backward": PREP_NORMS * b, "minplus": 2 * b}}
        for mode, metrics in results.items():
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"cli.adapt {mode}: {metrics}")
    finally:
        ExperimentManager.setup_optimizer = orig_setup_optimizer
        surface_module.squared_edt_volumes = squared_edt_volumes
        managers.clear()
    out["edt"] = [{"shape": list(p.shape), "bitwise_plain": torch.equal(got, squared_edt_volumes_plain(p, sp, sqrt=s))}
                  for p, sp, s, got in edt_in]
    del edt_in
    if len(out["edt"]) != out["train"]["val_batches"] + 2 * out["adapt"]["test_batches"] or not all(
            e["bitwise_plain"] for e in out["edt"]):
        raise AssertionError(f"phase 21 EDTs: {out['edt']}")

    # (e) the ops nothing calls
    out["ops"] = unused_ops_phase(dev, rows[0]["ct_proc"], rows[0]["pt_proc"], **(ops_kw or {}))
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 22: the data axis over ranks ---------------------------------------
# two ranks share the one card (training.devices=[0, 0]); the global batches
# are the recipe's, rank r steps on rows [r*B/2, (r+1)*B/2)
DP_WORLD = 2
DP_VOLUMES = 24  # the sharded store: 12 volumes a rank, 3 steps of 4 a rank in one epoch
DP_STEPS = DP_VOLUMES // TRAIN_BATCH
DP_VAL = 3  # the validation batch: ragged over the ranks (2 + 1 and a padded row)
DP_TENT_BATCHES = 2  # Tent online and strict, each over this many batches of BATCH
DP_EVAL_SIZES = (2, 2, 1)  # TTAEngine.evaluate's batches, the last ragged
DP_TIMED_TENT = 4
# the f32 gate (TF32 off), two ranks vs one process on the same global
# batches (the ranks add their partial sums, one process sums the batch: f32
# sums in another order): losses and entropies relative; Tent's adapted norm
# tensors' deltas relative L2 (phase 12's limit, TRAIN_DELTA_REL); metrics
# absolute plus relative; predictions' equal voxels. Training: the losses at
# every step, and the first step's gradients (relative L2 of all 82 tensors
# together), split in two by a witness in the one process: the two ranks'
# summed gradients against the one process's own sum of two batch-4
# backward passes, rows [0, 4) and [4, 8), within DP_GRAD_RANKS_REL (the
# same cuDNN reductions, added once: 8.3e-9 on an NVIDIA H100 80GB HBM3 at
# 700 W); and that sum against the one process's batch-8 pass within
# DP_GRAD_REL, where cuDNN's weight gradient reduces 8 samples in another
# order than twice 4 (2.63e-5 there, all of the ranks' distance). The
# params' moves over the 3 steps are read, not gated: Adam's first steps
# move every element by about lr whatever its gradient's size, so they
# cannot see a gradient's scale; the gradients carry that check
DP_LOSS_REL = 1e-5
DP_GRAD_RANKS_REL = 1e-6
DP_GRAD_REL = 1e-4
DP_DELTA_REL = TRAIN_DELTA_REL
DP_METRIC_ABS, DP_METRIC_REL = 1e-5, 1e-5
DP_PRED_AGREE = 0.9999
DP_TIMEOUT_S = 600


def dp_config(save_dir: str, dtype: str, world: int) -> dict:
    """The HECKTOR21 recipe (``train_recipe``) for phase 22: one epoch, zero1,
    the sharded device cache, ``training.devices`` with card 0 for each of
    the ``world`` ranks, ``compute_dtype``."""
    cfg = train_recipe(save_dir)
    cfg["training"].update({"epochs": 1, "compute_dtype": dtype, "zero1": True, "device_cache": True,
                            "device_cache_sharded": True, "devices": [0] * world, "batch_size": TRAIN_BATCH})
    return cfg


def dp_sharded_order(n: int, batch: int, world: int, seed: int, epoch: int = 0) -> list:
    """The sample ids of each global batch of the sharded store over
    ``world`` ranks (``data/device_cache.py``: rank r's block, the tail
    wrapped, its Philox permutation): what one process is given."""
    import numpy as np

    per, bsl = -(-n // world), batch // world
    blocks = [np.arange(r * per, (r + 1) * per) % n for r in range(world)]
    perms = [np.random.Generator(np.random.Philox(key=[seed + 0x9E3779B9 * (r + 1), epoch])).permutation(per)
             for r in range(world)]
    return [np.concatenate([blocks[r][perms[r][k * bsl:(k + 1) * bsl]] for r in range(world)])
            for k in range(per // bsl)]


def dp_data(shape, volumes: int) -> dict:
    """Phase 22's volumes (from seeds): the training set, whose volumes the
    Tent and evaluation batches reuse, and the validation batch. Made once
    and handed to every process in a file."""
    return {"train": hecktor_volumes(volumes, 220, shape), "val": hecktor_volumes(DP_VAL, 221, shape)}


def _stack(vols, dtype=None) -> dict:
    import numpy as np

    image = np.stack([v["image"] for v in vols])
    return {"image": image if dtype is None else image.astype(dtype),
            "label": np.stack([v["label"] for v in vols]), "domain": [v["domain"] for v in vols]}


def dp_run(device, root: str, mesh, spec: dict) -> dict:
    """Phase 22's main path in this process: over the ranks of ``mesh``, or
    in one process (``mesh`` None) on the same global batches. Training of
    the recipe in f32 through ``ExperimentManager`` (zero1 and the sharded
    device cache over ranks; the store's global batches in one process),
    one validation batch, Tent online and strict on global batches of 2,
    ``TTAEngine.evaluate`` with continual Tent over 3 batches (the last
    ragged); the launches of each part; on the card each kernel against its
    plain version on this process's inputs, then bf16 timing of the
    training and Tent steps."""
    import numpy as np
    import torch

    import multimodal_tta_tpu_torch.models.layers as layers_module
    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.data import get_seg_transforms
    from multimodal_tta_tpu_torch.data.device_cache import DeviceCachedLoader
    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus, squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm, instance_norm_backward_plain
    from multimodal_tta_tpu_torch.parallel.mesh import Mesh
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_part, parts = time.perf_counter(), {}  # seconds by part

    def part(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    shape, world = tuple(spec["shape"]), DP_WORLD if mesh is not None else 1
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    rank = mesh.rank if mesh is not None else 0
    tag = f"rank{rank}" if mesh is not None else "one"
    data = torch.load(spec["data"], weights_only=False)  # dp_data's, written by the phase
    data["tent"] = data["train"][:(2 * DP_TENT_BATCHES + DP_TIMED_TENT) * BATCH]
    data["eval"] = data["train"][-sum(DP_EVAL_SIZES):]
    part("data")
    spec_t = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                                image_size=shape, intensity_policy=HECKTOR_POLICY, channel_names=["ct", "pt"],
                                on_device=True).device_spec()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches, "plain_backward": instance_norm_backward_plain.cuda_calls}

    def since(at: dict) -> dict:
        now = counts()
        return {k: now[k] - at[k] for k in now}

    def rows(x):
        return x if mesh is None else x[mesh.rows(x.shape[0])]

    def gather(t):
        return t if mesh is None else mesh.gather_rows(t)

    class Steps(HookBase):
        """Each step's global loss, the first step's gradients (summed over
        the ranks; rank 0's) and, with ``timed``, its ms."""

        def __init__(self, timed: bool):
            self.timed, self.losses, self.ms, self.grads = timed, [], [], None

        def before_train_step(self):
            if self.timed:
                sync()
                self._t = time.perf_counter()

        def after_train_step(self):
            self.losses.append(self.trainer._pending_loss)
            if self.grads is None and not self.timed and rank == 0:
                self.grads = {n: p.grad.detach().cpu().clone()
                              for n, p in self.trainer.state.model.named_parameters() if p.grad is not None}
            if self.timed:
                sync()
                self.ms.append((time.perf_counter() - self._t) * 1e3)

    def manager(dtype: str, sub: str, timed: bool):
        cfg = dp_config(os.path.join(root, f"{tag}_{sub}"), dtype, world)
        cfg["model"]["channels"] = list(spec["channels"])
        cfg["training"]["model_save_start"] = 10**6  # the f32 run writes best_model only
        if timed:  # the timing run trains only
            cfg["training"]["eval_test"]["do_val"] = False
        m = ExperimentManager(ConfigNode(cfg), device=dev, mesh=mesh if mesh is not None else Mesh(dev))
        m.setup_model()
        m.setup_optimizer()
        m.setup_scheduler()
        if mesh is not None:
            m.train_loader = DeviceCachedLoader(data["train"], batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                                                seed=0, device=dev, num_workers=4, shard_store=True, mesh=mesh)
        else:
            order = dp_sharded_order(len(data["train"]), TRAIN_BATCH, DP_WORLD, seed=0)
            m.train_loader = [_stack([data["train"][i] for i in ids], np.float16) for ids in order]
        m.val_loader = [_stack(data["val"])]
        m.device_transform = spec_t
        m.setup_trainer(os.path.join(root, f"{tag}_{sub}"))
        steps = Steps(timed)
        m.trainer.register_hooks([steps])
        return m, steps

    out = {"tag": tag, "rank": rank, "device": str(dev)}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # ---- the main path, in f32 -------------------------------------------------
    m, steps = manager("float32", "f32", timed=False)
    part("setup")
    model = m.model
    # Tent and evaluation start from the initial weights (equal in every
    # process), not from the trained ones (which differ by the training's rounding)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    sums = []  # each step's samples, by their first 16 values: the store's order, seen from here
    loader = m.train_loader

    class Seen:
        def __iter__(self):
            for b in loader:
                img = torch.as_tensor(b["image"])
                sums.append(img.reshape(img.shape[0], -1)[:, :16].float().cpu())
                yield b

        def __len__(self):
            return len(loader)

        def set_epoch(self, e):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(e)

    m.train_loader = Seen()
    if mesh is not None:
        m.train_loader.device_resident = True
    val_edt, norm_in, witness = [], {}, {}

    def recording_edt(pts, spacing, *, sqrt=False):
        got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        val_edt.append((pts.clone(), spacing, sqrt, got.clone()))
        return got

    def recording_norm(x, gamma, beta, *, eps=1e-5, act="relu"):
        """The kernel; the first input the path gives it at each shape,
        dtype and activation is kept (on the host, outside the peak) for
        the check against the plain version."""
        key = (tuple(x.shape), str(x.dtype), act)
        if cuda and key not in norm_in:
            norm_in[key] = tuple(t.detach().cpu() for t in (x, gamma, beta))
        return fused_instance_norm(x, gamma, beta, eps=eps, act=act)

    if mesh is None:  # the witness of the ranks' first step (dp_compare), before that step moves anything
        step = m.trainer._step

        def witness_step(image, label, n_valid):
            if not witness:
                w_at = counts()
                witness["grads"] = rank_view_grads(m.trainer, step, image, label, n_valid, DP_WORLD)
                witness["launches"] = since(w_at)
            return step(image, label, n_valid)

        m.trainer._step = witness_step

    surface_module.squared_edt_volumes = recording_edt
    layers_module.fused_instance_norm = recording_norm
    try:
        at = counts()
        history = m.train(1)
        sync()
        out["launches"] = {"train": since(at)}
        if witness:  # the witness's passes are no launch of the path
            out["launches"]["train"] = {k: v - witness["launches"][k] for k, v in out["launches"]["train"].items()}
        part("train_and_validation")
        out["losses"] = [float(v) for v in steps.losses]
        out["step_sums"] = [s.tolist() for s in sums]
        out["val"] = history["eval_history"][0]
        out["optimizer_state_bytes"] = _optimizer_state_bytes(m.trainer.state.optimizer)
        grads = sum(p.numel() for p in model.parameters() if p.requires_grad)
        out["train_allreduce_bytes"] = 4 * (grads + 1) if mesh is not None else 0
        out["checkpoints"] = sorted(f for f in os.listdir(os.path.join(root, f"{tag}_f32", "checkpoints"))) \
            if os.path.isdir(os.path.join(root, f"{tag}_f32", "checkpoints")) else []
        if mesh is not None:  # the trained state as orbax, each rank its own zero1 partition; then msgpack
            from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint

            ckpt = os.path.join(spec["ranks_root"], "zero1_orbax", "state")
            t_save = time.perf_counter()
            save_checkpoint(ckpt, m.trainer.state, fmt="orbax")
            out["orbax"] = {"save_s": time.perf_counter() - t_save,
                            "bytes": tree_bytes(os.path.join(ckpt + ".orbax", f"ocdbt.process_{rank}"))}
            save_checkpoint(ckpt, m.trainer.state)
            part("orbax_checkpoint")
        if rank == 0:
            out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            out["init"] = {n: t.cpu() for n, t in init.items()}
            out["grads"] = steps.grads

        # Tent online (continual, inline) and strict (episodic, post)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        tent = [_stack(data["tent"][i * BATCH:(i + 1) * BATCH])["image"] for i in range(2 * DP_TENT_BATCHES)]
        source = {n: p.detach().clone() for n, p in model.named_parameters()}
        norm = [n for n, k in norm_param_mask(model).items() if k]
        out["tent"] = {}
        for mode, episodic, batches in (("inline", False, tent[:DP_TENT_BATCHES]), ("post", True, tent[DP_TENT_BATCHES:])):
            cfg = ConfigNode(eval_config("tent", episodic))
            ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
            fn = ad.make_adapt_predict_fn(model, THRESHOLD, mode)
            at = counts()
            preds, ents = [], []
            for x in batches:
                _, pred = fn(model, torch.from_numpy(rows(x)), x.shape[0])
                preds.append(gather(pred).cpu())
                ents.append(ad._last_ents.cpu())
            sync()
            out["launches"][f"tent_{mode}"] = since(at)
            adapted = {n: dict(model.named_parameters())[n].detach().cpu().clone() for n in norm}
            ad.restore()
            out["tent"][mode] = {"ents": [e.tolist() for e in ents], "preds": preds if rank == 0 else None,
                                 "adapted": adapted if rank == 0 else None}
        part("tent")
        out["tent_allreduce_bytes"] = 4 * (sum(source[n].numel() for n in norm) + 1) if mesh is not None else 0
        out["source_norm"] = {n: source[n].cpu() for n in norm} if rank == 0 else None

        # TTAEngine.evaluate with continual Tent, the last batch ragged
        ev, i0 = [], 0
        for b in DP_EVAL_SIZES:
            ev.append(_stack(data["eval"][i0:i0 + b]))
            i0 += b
        engine = TTAEngine(ConfigNode(eval_config("tent", False)), device_transform=DEVICE_TRANSFORM, device=dev,
                           mesh=mesh)
        at = counts()
        out["eval"] = engine.evaluate(model, ev)
        sync()
        out["launches"]["evaluate"] = since(at)
        part("evaluate")
    finally:
        surface_module.squared_edt_volumes = squared_edt_volumes
        layers_module.fused_instance_norm = fused_instance_norm
    out["witness_grads"] = witness.get("grads")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None

    # ---- each kernel against its plain version on this process's inputs ------
    if cuda:
        g = torch.Generator(device=dev).manual_seed(22 + rank)
        norms = [{"shape": list(shape), "act": act} | norm_vs_plain(*(t.to(dev) for t in ins), act, g)
                 for (shape, _, act), ins in norm_in.items()]
        edt = [bool(torch.equal(o, squared_edt_volumes_plain(p, s, sqrt=q))) for p, s, q, o in val_edt]
        out["kernel_check"] = {"norm": norms, "norm_ok": bool(norms) and all(n["ok"] for n in norms),
                               "edt_bitwise": edt}
    else:
        out["kernel_check"] = None
    norm_in.clear()
    part("kernel_check")
    del m, model
    if cuda:
        torch.cuda.empty_cache()

    # ---- bf16 timing: the recipe's training step and the Tent step ----------------
    if spec.get("timed", cuda):
        torch.cuda.reset_peak_memory_stats(dev)
        mb, tsteps = manager("bfloat16", "bf16", timed=True)
        mb.train(1)
        cfg = ConfigNode(eval_config("tent", False))
        ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
        fn = ad.make_adapt_predict_fn(mb.model, THRESHOLD, "inline")
        tent_ms = []
        for i in range(DP_TIMED_TENT):
            x = tent[0] if i == 0 else _stack(data["tent"][(2 * DP_TENT_BATCHES + i) * BATCH:
                                                            (2 * DP_TENT_BATCHES + i + 1) * BATCH])["image"]
            sync()
            t1 = time.perf_counter()
            fn(mb.model, torch.from_numpy(rows(x)), x.shape[0])
            sync()
            tent_ms.append((time.perf_counter() - t1) * 1e3)
        out["timing"] = {"train_step_ms": tsteps.ms, "tent_step_ms": tent_ms,
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None}
        part("bf16_timing")
    out["part_s"] = parts
    return out


def norm_vs_plain(x, gamma, beta, act, gen) -> dict:
    """The norm kernels against their plain versions on one input of the
    path (f32): the forward within TOL_F32; the backward at a random output
    gradient, zero within KINK_MARGIN of the ReLU's kink (there the mask
    rightly depends on the statistics' summation order), on the kernel's
    statistics, each of dx, dgamma, dbeta within phase 2's f32 limit."""
    import torch

    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
        instance_norm_backward,
        instance_norm_backward_plain,
        instance_norm_forward,
        instance_norm_plain,
    )

    if x.dtype != torch.float32:
        raise ValueError(f"norm_vs_plain holds f32 inputs, got {x.dtype}")
    relu = act == "relu"
    y, stats = instance_norm_forward(x, gamma, beta, relu=relu)
    fwd = float((y - instance_norm_plain(x, gamma, beta, act=act)).abs().max())
    gy = torch.randn(x.shape, generator=gen, device=x.device)
    if relu:
        gy = torch.where(instance_norm_plain(x, gamma, beta, act=None).abs() < KINK_MARGIN, 0.0, gy)
    got = instance_norm_backward(gy, x, gamma, beta, stats, relu=relu)
    want = instance_norm_backward_plain(gy, x, gamma, beta, stats[0], stats[1], relu)
    bwd = [(float((a - w).abs().max()), GRAD_F32_REL * float(w.abs().max()) + GRAD_F32_ABS)
           for a, w in zip(got, want)]
    return {"forward_err": fwd, "backward_err": [e for e, _ in bwd],
            "ok": fwd <= TOL_F32["atol"] and all(e <= lim for e, lim in bwd)}


def rank_view_grads(trainer, step, image, label, n_valid: int, world: int) -> dict:
    """One process's witness of the ranks' first training step: each
    rank's rows of the global batch through the trainer's own ``step``
    (its ``_step``) under a stand-in mesh (rank r of ``world`` with no
    group, so a sum over the ranks is its own part), the ``world`` passes'
    gradients added in rank order. The update is skipped and the generator
    put back, so the real step that follows is untouched. On the host."""
    from multimodal_tta_tpu_torch.parallel.mesh import Mesh

    class RankView(Mesh):
        def __init__(self, rank: int):
            self.device, self.data, self.rank, self.group = trainer.mesh.device, world, rank, None

        def sum(self, t):
            return t

        def sum_with_grad(self, t):
            return t

    state, mesh, gen = trainer.state, trainer.mesh, trainer._gen.get_state()
    total = {}
    state.apply_gradients = lambda: False
    try:
        for r in range(world):
            trainer.mesh = RankView(r)
            rows = trainer.mesh.rows(image.shape[0])
            trainer._gen.set_state(gen)
            step(image[rows], label[rows], n_valid)
            for n, p in state.model.named_parameters():
                if p.grad is not None:
                    total[n] = total[n] + p.grad if n in total else p.grad.detach().clone()
    finally:
        del state.apply_gradients
        trainer.mesh = mesh
        trainer._gen.set_state(gen)
    return {n: t.cpu() for n, t in total.items()}


def _optimizer_state_bytes(optimizer) -> int:
    """The bytes of optimizer state this process holds (ZeRO-1: its
    partition's)."""
    import torch

    inner = getattr(optimizer, "optimizer", optimizer)  # through MultiSteps
    inner = getattr(inner, "optim", inner)  # ZeroRedundancyOptimizer's local optimizer
    return sum(t.numel() * t.element_size() for s in inner.state.values() for t in s.values() if torch.is_tensor(t))


def _dp_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """Phase 22's rank side in an initialised process group: the mesh of
    ``training.devices``, ``dp_run``."""
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.parallel.mesh import mesh_from_config

    mesh = mesh_from_config(ConfigNode(dp_config(spec["ranks_root"], "float32", world)), device)
    return dp_run(device, spec["ranks_root"], mesh, spec)


def _nccl_probe_rank(rank: int, root: str) -> None:
    """Two NCCL ranks on card 0: init and one all_reduce; the outcome in
    ``root``."""
    import datetime
    import json as _json

    import torch
    import torch.distributed as dist

    outcome = {"rank": rank}
    try:
        dist.init_process_group("nccl", init_method=f"file://{root}/store", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        torch.cuda.set_device(0)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        outcome.update(accepted=True, value=float(t[0]))
    except Exception as e:  # the probe's answer: recorded, and the phase picks its backend from it
        outcome.update(accepted=False, error=f"{type(e).__name__}: {e}"[:2000])
    finally:
        with open(os.path.join(root, f"probe{rank}.json"), "w", encoding="utf-8") as f:
            _json.dump(outcome, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def nccl_probe(root: str, timeout: float = 120.0) -> dict:
    """Whether NCCL takes two ranks on one card; what it says when it does
    not (or that it did not answer within ``timeout``)."""
    import multiprocessing as mp

    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_nccl_probe_rank, args=(r, root), daemon=True) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    hung = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    ranks = []
    for r in range(2):
        path = os.path.join(root, f"probe{r}.json")
        ranks.append(json.load(open(path, encoding="utf-8")) if os.path.exists(path)
                     else {"rank": r, "accepted": False, "error": "no answer" + (" (killed)" if hung[r] else "")})
    return {"accepted": all(r.get("accepted") for r in ranks), "ranks": ranks, "seconds": time.perf_counter() - t0}


def dp_compare(one: dict, ranks: list) -> dict:
    """The two-rank run against the one-process run: what agrees and by how
    much, every check made before any failure raises."""
    import torch

    r0 = ranks[0]
    out, failed = {"ranks": len(ranks)}, []
    for r, res in enumerate(ranks):  # the store's order: rank r holds rows [r*4, r*4+4) of each global batch
        for k, s in enumerate(res["step_sums"]):
            want = one["step_sums"][k][r * len(s):(r + 1) * len(s)]
            if s != want:
                failed.append(f"rank {r} step {k} samples {s}, one process's rows {want}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
    out["losses"] = {"ranks": r0["losses"], "one": one["losses"], "max_rel": loss_rel}
    if any(res["losses"] != r0["losses"] for res in ranks) or loss_rel > DP_LOSS_REL:
        failed.append(f"losses {[res['losses'] for res in ranks]} vs {one['losses']}")
    # the params moved by the steps: Adam scales each gradient by its own
    # RMS, so an element whose true gradient is near zero moves by up to lr
    # either way at the rounding of its sum; held, as phase 12 holds the
    # kernel against the plain norm, by the deltas' relative L2
    names = sorted(one["params"])
    d_one = {n: one["params"][n] - one["init"][n] for n in names}
    d_ranks = {n: r0["params"][n] - r0["init"][n] for n in names}
    diff = torch.cat([(d_ranks[n] - d_one[n]).flatten() for n in names])
    delta_rel = float(diff.norm() / torch.cat([d_one[n].flatten() for n in names]).norm())
    apart = sorted(((float((d_ranks[n] - d_one[n]).norm() / d_one[n].norm().clamp_min(1e-30)), n) for n in names),
                   reverse=True)[:3]
    flipped = sum(int(((d_ranks[n] * d_one[n]) < 0).sum()) for n in names)
    grads = sorted(one["grads"])
    halves = one["witness_grads"]  # one process: rows [0, 4) and [4, 8) in two passes, added

    def grad_rel(a: dict, b: dict) -> float:
        return float(torch.cat([(a[n] - b[n]).flatten() for n in grads]).norm()
                     / torch.cat([b[n].flatten() for n in grads]).norm())

    g_rel, g_ranks_halves, g_halves_one = grad_rel(r0["grads"], one["grads"]), grad_rel(r0["grads"], halves), \
        grad_rel(halves, one["grads"])
    g_apart = sorted(((float((r0["grads"][n] - one["grads"][n]).norm() / one["grads"][n].norm().clamp_min(1e-30)),
                       n) for n in grads), reverse=True)[:3]
    out["params"] = {"first_step_grad_rel_l2": g_rel, "ranks_vs_two_half_passes": g_ranks_halves,
                     "two_half_passes_vs_batch_8": g_halves_one, "grads_most_apart": g_apart,
                     "grad_tensors": len(grads), "delta_rel_l2": delta_rel, "most_apart": apart,
                     "moved_the_other_way": flipped, "elements": sum(d_one[n].numel() for n in names),
                     "max_abs": max(float((r0["params"][n] - one["params"][n]).abs().max()) for n in names),
                     "init_equal": all(torch.equal(r0["init"][n], one["init"][n]) for n in names)}
    if (g_ranks_halves > DP_GRAD_RANKS_REL or g_halves_one > DP_GRAD_REL or len(grads) != len(names)
            or sorted(halves) != grads or not out["params"]["init_equal"]):
        failed.append(f"params after the steps: {out['params']}")

    def metrics_diff(a: dict, b: dict, what: str) -> float:
        if set(a) != set(b):
            failed.append(f"{what}: keys differ")
            return float("nan")
        diff = max(abs(a[k] - b[k]) for k in b if isinstance(b[k], float))
        if any(abs(a[k] - b[k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(b[k]) for k in b if isinstance(b[k], float)):
            failed.append(f"{what}: {a} vs {b}")
        return diff

    if any(res["val"] != r0["val"] or res["eval"] != r0["eval"] for res in ranks):
        failed.append("the ranks' metrics differ")
    out["val_max_abs"] = metrics_diff(r0["val"], one["val"], "validation")
    out["eval_max_abs"] = metrics_diff(r0["eval"], one["eval"], "TTAEngine.evaluate")
    out["tent"] = {}
    for mode, t in r0["tent"].items():
        o = one["tent"][mode]
        ent_rel = max(abs(a - b) / abs(b) for ea, eb in zip(t["ents"], o["ents"]) for a, b in zip(ea, eb))
        agree = min(float((a == b).float().mean()) for a, b in zip(t["preds"], o["preds"]))
        keys = sorted(o["adapted"])  # the relative L2 of the 36 tensors' deltas together
        diff = torch.cat([(t["adapted"][k] - o["adapted"][k]).flatten() for k in keys])
        delta = torch.cat([(o["adapted"][k] - one["source_norm"][k]).flatten() for k in keys])
        rel = float(diff.norm() / delta.norm())
        out["tent"][mode] = {"ents_max_rel": ent_rel, "pred_agree": agree, "delta_rel_l2": rel}
        if any(res["tent"][mode]["ents"] != t["ents"] for res in ranks):
            failed.append(f"Tent {mode}: the ranks' entropies differ")
        if ent_rel > DP_LOSS_REL or agree < DP_PRED_AGREE or rel > DP_DELTA_REL:
            failed.append(f"Tent {mode}: {out['tent'][mode]}")
    if failed:
        raise AssertionError("phase 22, two ranks vs one process: " + "; ".join(failed) + f"; all: {out}")
    return out


def dp_torchrun_cli(manifest: str, root: str, timeout: float = 600.0, two_ranks: bool = False) -> dict:
    """``cli.train`` then ``cli.adapt`` (Tent) as a user with N cards
    launches them, under ``torch.distributed.run --nproc_per_node=1`` (the
    default backend, NCCL, one rank) on phase 14's fixture: 1 epoch, then
    Tent from its best checkpoint; the group's line names the backend, and
    the log, the metrics file and the checkpoints exist. With ``two_ranks``
    also ``cli.adapt`` over two ranks on card 0 (``training.devices=[0,0]``,
    gloo, as the CLI chooses for ranks that share a card)."""
    out = {}
    best = f"training.resume={os.path.join(root, 'train', 'checkpoints', 'best_model')}"
    runs = [("train", 1, "nccl", ["training.epochs=1"]),
            ("adapt", 1, "nccl", ["tta=tent", "tta.report_no_adapt=true", best])]
    if two_ranks:
        runs.append(("adapt", 2, "gloo", ["tta=tent", "tta.report_no_adapt=true", best, "training.devices=[0,0]"]))
    for call, ranks, backend, extra in runs:
        tag = call if ranks == 1 else f"{call}_{ranks}_ranks"
        run_dir = os.path.join(root, tag)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={ranks}", "-m",
               f"multimodal_tta_tpu_torch.cli.{call}", *cli_overrides(manifest, run_dir, *extra)]
        t0 = time.perf_counter()
        proc = run_command(cmd, timeout)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun cli.{call} exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        # the group starts before rank 0 opens its log file: its line is on stdout
        groups = re.findall(rf"torch\.distributed initialized: rank (\d)/{ranks} \(local rank \d\), backend (\w+)",
                            proc.stdout)
        if sorted(groups) != [(str(r), backend) for r in range(ranks)] \
                or not os.path.exists(os.path.join(run_dir, f"{call}.log")):
            raise AssertionError(f"torchrun cli.{call} over {ranks}: groups {groups}, not {backend}, or no log "
                                 f"file:\n{proc.stdout[-4000:]}")
        r = {"wall_s": wall, "ranks": ranks, "backend": backend}
        if call == "train":
            r["checkpoints"] = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            if "best_model.msgpack" not in r["checkpoints"]:
                raise AssertionError(f"torchrun cli.train wrote {r['checkpoints']}")
        else:
            metrics = json.load(open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8"))
            r["metrics"] = {k: metrics["adapted"][k] for k in ("gtvt_dc", "avg_hd95", "loss")
                            if k in metrics["adapted"]}
            if not all(math.isfinite(v) for v in r["metrics"].values()) or "no_adapt" not in metrics:
                raise AssertionError(f"torchrun cli.adapt metrics {metrics}")
        out[tag] = r
    return out


def data_parallel_phase(device, root: str, **kw) -> dict:
    """Phase 22: the NCCL probe (on a card; ``probe``, its result, when it
    ran before), two ranks sharing the device (``training.devices=[0, 0]``,
    spawned here over the probe's backend, or ``backend``) against the one-process run here on the same global
    batches, each rank's launches exactly, its kernels against their plain
    versions. Its command lines under torchrun are ``dp_torchrun_cli``;
    ``main`` spawns its ranks with phases 23-24's (``spawn_pairs``)."""
    prep = data_parallel_prepare(device, root, **kw)
    spawn_pairs([prep])
    return data_parallel_finish(prep)


def data_parallel_prepare(device, root: str, *, shape=SHAPE[:3], channels=(32, 64, 128, 256, 512),
                          volumes: int = DP_VOLUMES, backend=None, probe=None, threads: int = 4) -> dict:
    """Phase 22 up to its ranks: the probe, the backend, the data, the
    ranks' spec (``spawn_pairs`` runs them)."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    out = {}
    if backend is None:
        if cuda:
            out["nccl_probe"] = probe or nccl_probe(os.path.join(root, "probe"))
            backend = "nccl" if out["nccl_probe"]["accepted"] else "gloo"
        else:
            backend = "gloo"
    out["backend"] = backend
    log(f"[data_parallel] two ranks on {device} over {backend}" + (
        f" (NCCL probe: {'accepted' if out['nccl_probe']['accepted'] else 'refused'}, "
        f"{[r.get('error', 'ok')[:300] for r in out['nccl_probe']['ranks']]}, "
        f"{out['nccl_probe']['seconds']:.1f} s)" if "nccl_probe" in out else ""))
    spec = {"shape": list(shape), "channels": list(channels), "threads": threads,
            "data": os.path.join(root, "data.pt")}
    torch.save(dp_data(shape, volumes), spec["data"])
    spec["ranks_root"] = os.path.join(root, "ranks")
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "data_parallel", "device": device, "root": root, "t0": t0, "cuda": cuda, "out": out,
            "backend": backend, "spec": spec}


def data_parallel_finish(prep: dict) -> dict:
    """Phase 22 after its ranks: the one-process run and the checks."""
    import shutil

    import torch

    device, root, t0, cuda, out, spec = (prep[k] for k in ("device", "root", "t0", "cuda", "out", "spec"))
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    t1 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(spec["threads"])  # the ranks' host threads: on the CPU the same reductions as theirs
    try:
        one = dp_run(device, os.path.join(root, "one"), None, spec)
    finally:
        torch.set_num_threads(threads)
    out["one_s"] = time.perf_counter() - t1
    out["compare"] = dp_compare(one, ranks)
    per_forward = 18 if cuda else 0
    steps = len(one["losses"])
    want = {"train": {"forward": per_forward * (steps + 1), "backward": per_forward * steps, "minplus": int(cuda)},
            "tent_inline": {"forward": per_forward * DP_TENT_BATCHES, "backward": per_forward * DP_TENT_BATCHES,
                            "minplus": 0},
            "tent_post": {"forward": 2 * per_forward * DP_TENT_BATCHES, "backward": per_forward * DP_TENT_BATCHES,
                          "minplus": 0},
            "evaluate": {"forward": 2 * per_forward * len(DP_EVAL_SIZES),
                         "backward": per_forward * len(DP_EVAL_SIZES), "minplus": int(cuda) * len(DP_EVAL_SIZES)}}
    for res in ranks + [one]:
        for part, w in want.items():
            if res["launches"][part] != {**w, "plain_backward": 0}:
                raise AssertionError(f"phase 22 {res['tag']} {part}: launches {res['launches'][part]}, derived {w}")
        kc = res["kernel_check"]
        if cuda and not (kc["norm_ok"] and kc["edt_bitwise"] and all(kc["edt_bitwise"])):
            raise AssertionError(f"phase 22 {res['tag']} kernels vs plain: {kc}")
    if cuda:  # the norm checked at each rank's own batches: training's 4, Tent's and evaluate's 1
        for res in ranks:
            held = {n["shape"][0] for n in res["kernel_check"]["norm"]}
            if not {TRAIN_BATCH // DP_WORLD, BATCH // DP_WORLD} <= held:
                raise AssertionError(f"phase 22 {res['tag']}: the norm held at batches {sorted(held)} only")
    out["launches"] = {k: sum(res["launches"][p][k] for res in ranks for p in want)
                       for k in ("forward", "backward", "minplus")}
    out["ranks"] = [{k: res[k] for k in ("tag", "device", "launches", "kernel_check", "optimizer_state_bytes",
                                         "train_allreduce_bytes", "tent_allreduce_bytes", "peak_gib", "losses",
                                         "val", "eval", "checkpoints", "part_s") if k in res}
                    | {"timing": res.get("timing")} for res in ranks]
    out["one"] = {k: one.get(k) for k in ("launches", "kernel_check", "optimizer_state_bytes", "peak_gib", "losses",
                                          "val", "eval", "timing", "part_s")}
    if ranks[0]["optimizer_state_bytes"] + ranks[1]["optimizer_state_bytes"] < one["optimizer_state_bytes"] \
            or max(r["optimizer_state_bytes"] for r in ranks) >= one["optimizer_state_bytes"]:
        raise AssertionError(f"phase 22 zero1: state bytes {[r['optimizer_state_bytes'] for r in ranks]} vs "
                             f"{one['optimizer_state_bytes']} in one process")
    if not all("best_model.msgpack" in r["checkpoints"] for r in ranks[:1]):
        raise AssertionError(f"phase 22: rank 0 wrote {ranks[0]['checkpoints']}")
    # rank 0's zero1 checkpoint (the moments consolidated over both ranks)
    # in one process, written again: the same bytes
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.parallel.mesh import Mesh

    cfg = dp_config(os.path.join(root, "rewrite"), "float32", 1)
    cfg["model"]["channels"] = list(spec["channels"])
    dev = torch.device(device)
    m = ExperimentManager(ConfigNode(cfg), device=dev, mesh=Mesh(dev))
    m.setup_model()
    m.setup_optimizer()
    ckpt = os.path.join(spec["ranks_root"], "rank0_f32", "checkpoints", "best_model")
    t1 = time.perf_counter()
    m.state, _ = load_checkpoint(ckpt, m.state)
    out["zero1_rewrite"] = dict(rewrite_check(m.state, ckpt, os.path.join(root, "rewrite", "best_model")),
                                load_s=time.perf_counter() - t1)
    if not out["zero1_rewrite"]["identical"]:
        raise AssertionError(f"phase 22: rank 0's zero1 checkpoint read and written again differs: "
                             f"{out['zero1_rewrite']}")
    del m
    # the ranks' orbax file (each wrote its own partition's moments) read in
    # one process: every leaf bitwise the leaf of rank 0's msgpack of that state
    out["zero1_orbax"] = orbax_against_msgpack(os.path.join(spec["ranks_root"], "zero1_orbax", "state"))
    out["zero1_orbax"]["rank_bytes"] = [r["orbax"]["bytes"] for r in ranks]
    out["zero1_orbax"]["save_s"] = [r["orbax"]["save_s"] for r in ranks]
    if not out["zero1_orbax"]["bitwise"] or min(out["zero1_orbax"]["rank_bytes"]) == 0:
        raise AssertionError(f"phase 22: the ranks' zero1 orbax checkpoint: {out['zero1_orbax']}")
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return out


def orbax_against_msgpack(path: str) -> dict:
    """``path.orbax`` (written over ranks) read in one process against
    ``path.msgpack`` of the same state: every leaf bitwise, the seconds of
    the read, the bytes of each file."""
    import torch

    from multimodal_tta_tpu_torch.core import flax_msgpack, orbax_format

    def leaves(payload) -> dict:
        out = {}
        for keys, v in orbax_format.flatten(payload):
            out[".".join(k for k, _ in keys)] = v if isinstance(v, str) else torch.as_tensor(v)
        return out

    t0 = time.perf_counter()
    got = leaves(orbax_format.load(path + ".orbax"))
    read_s = time.perf_counter() - t0
    want = leaves(flax_msgpack.load(path + ".msgpack"))
    same = got.keys() == want.keys() and all(
        got[k] == v if isinstance(v, str) else (got[k].dtype == v.dtype and got[k].shape == v.shape
                                                and torch.equal(got[k], v)) for k, v in want.items())
    return {"bitwise": same, "leaves": len(want), "read_s": read_s, "orbax_bytes": tree_bytes(path + ".orbax"),
            "msgpack_bytes": os.path.getsize(path + ".msgpack")}


def kernel_check_text(kc) -> str:
    """Phase 22's kernel checks of one process, in a few words."""
    if kc is None:
        return "none (CPU)"
    norms = kc["norm"]
    return (f"the norm at {len(norms)} path inputs (shape, activation: {[(n['shape'], n['act']) for n in norms]}), "
            f"max forward error {max(n['forward_err'] for n in norms):.3g} (limit {TOL_F32['atol']}), max backward "
            f"errors dx/dgamma/dbeta {[max(n['backward_err'][i] for n in norms) for i in range(3)]} (limit "
            f"{GRAD_F32_REL} x max|plain| + {GRAD_F32_ABS} each), ok {kc['norm_ok']}; the EDT bitwise "
            f"{kc['edt_bitwise']}")


def log_data_parallel(dp: dict, card: str) -> None:
    """Phase 22's numbers, a line each."""
    import statistics

    def warm(ms):  # the first call compiles and warms up
        return statistics.median(ms[1:]) if len(ms) > 1 else float("nan")

    c, one = dp["compare"], dp["one"]
    log(f"[data_parallel] two ranks vs one process on the same global batches (f32, TF32 off): losses "
        f"{c['losses']['ranks']} vs {c['losses']['one']} (max rel {c['losses']['max_rel']:.3g}, limit {DP_LOSS_REL}); "
        f"gradients and params {c['params']} (limits: the first step's gradients, the ranks' against one process's "
        f"two batch-4 passes {DP_GRAD_RANKS_REL}, those against its batch-8 pass {DP_GRAD_REL}; the moves are "
        f"read, not gated); "
        f"validation metrics max abs {c['val_max_abs']:.3g}, TTAEngine.evaluate {c['eval_max_abs']:.3g} (limit "
        f"{DP_METRIC_ABS} + {DP_METRIC_REL} x |value|); Tent {c['tent']} (limits: entropies {DP_LOSS_REL}, "
        f"deltas {DP_DELTA_REL}, predictions {DP_PRED_AGREE}); ranks {dp['ranks_s']:.1f} s, one process "
        f"{dp['one_s']:.1f} s; "
        f"card {card}")
    ot = one.get("timing") or {}
    for r in dp["ranks"]:
        t = r.get("timing") or {}
        log(f"[data_parallel] {r['tag']} on {r['device']}: launches {r['launches']}; kernels vs plain on this "
            f"rank's inputs: {kernel_check_text(r['kernel_check'])}; ms per bf16 training step (4 of the global 8) "
            f"{[round(v, 2) for v in t.get('train_step_ms', [])]} "
            f"-> warm median {warm(t.get('train_step_ms', [])):.2f} vs one process at 8 "
            f"{warm(ot.get('train_step_ms', [])):.2f}; ms per bf16 Tent step (1 of the global 2) "
            f"{[round(v, 2) for v in t.get('tent_step_ms', [])]} -> {warm(t.get('tent_step_ms', [])):.2f} vs one "
            f"process at 2 {warm(ot.get('tent_step_ms', [])):.2f}; all-reduced per training step "
            f"{r['train_allreduce_bytes']} bytes, per Tent step {r['tent_allreduce_bytes']} bytes; optimizer state "
            f"{r['optimizer_state_bytes']} bytes with zero1 vs {one['optimizer_state_bytes']} without (one process); "
            f"peak allocated {r['peak_gib']} GiB (the f32 main path), {t.get('peak_gib')} GiB (the bf16 runs) "
            f"(one process: {one['peak_gib']}, {ot.get('peak_gib')}); s by part {r['part_s']} (one process "
            f"{one['part_s']}); card {card}")
    if "torchrun" in dp:
        log(f"[data_parallel] torchrun --nproc_per_node=1: {dp['torchrun']}; card {card}")
    zr = dp["zero1_rewrite"]
    log(f"[data_parallel] rank 0's zero1 checkpoint (best_model.msgpack, {zr['bytes']} bytes) restored in one "
        f"process in {zr['load_s']:.3f} s and written again in {zr['save_s']:.3f} s: identical bytes "
        f"{zr['identical']}; card {card}")
    zo = dp["zero1_orbax"]
    log(f"[data_parallel] the ranks' zero1 state as orbax ({zo['orbax_bytes']} bytes; each rank wrote its own "
        f"partition: {zo['rank_bytes']} bytes in {[round(t, 3) for t in zo['save_s']]} s) read in one process in "
        f"{zo['read_s']:.3f} s: {zo['leaves']} leaves bitwise rank 0's msgpack of that state ({zo['msgpack_bytes']} "
        f"bytes): {zo['bitwise']}; card {card}")
    log(f"[data_parallel] phase 22 took {dp['phase_s']:.1f} s; launches over both ranks {dp['launches']}; "
        f"backend {dp['backend']}; card {card}")


# ---- phase 23: the space axis over ranks ---------------------------------------
# two ranks share the one card (training.devices=[0, 0], gloo), training.mesh
# data=1 x space=2: each rank holds every row of the global batch and half its
# depth (parallel/space.py)
SP_WORLD = 2
SP_STEPS = 2  # f32 training steps of the recipe at global batch 8 (and bf16 steps timed)
SP_VAL = 2  # the validation batch
SP_TENT_BATCHES = 2  # Tent online and strict, each over this many batches of BATCH
SP_EVAL_SIZES = (2, 1)  # TTAEngine.evaluate's batches
SP_TIMED = 3  # bf16 Tent steps timed
SP_MID_BATCH = 1  # the mid-fusion UNet's f32 training step at BRATS_SHAPE
SP_TIMEOUT_S = 600
SP_TRAIN_SEED = 230  # the training set's volumes (Tent, evaluation and the other models reuse them)
# the f32 gates (TF32 off), two ranks vs one process on the same global
# batches: losses and entropies relative (the slabs' partial sums added in
# another order than one process's sums); the first step's gradients (all
# tensors together, summed over the ranks: a gamma/beta or a whole level's
# gradient counted twice is off by its own size) relative L2, where cuDNN's
# weight gradients over two half-depth slabs reduce in another order than
# over the whole depth (phase 22 measured that kind of distance at 2.63e-5);
# Tent's adapted tensors' deltas relative L2 (phase 12's limit); metrics;
# predictions' equal voxels
# The mid-fusion UNet's step at BraTS size (every level split) takes its
# own gradient limit: its f32 gradients are ill-conditioned in the norms'
# statistics, so that one process moves them by about as much when only
# the order of those sums changes (torch's reductions instead of the
# kernel's: scripts/torch_space_parallel.py --witnesses)
SP_LOSS_REL = 1e-5
SP_GRAD_REL = 1e-4
SP_MID_GRAD_REL = 1e-3
SP_DELTA_REL = TRAIN_DELTA_REL
SP_PRED_AGREE = 0.9999
SPLIT_ENTRIES = ("instance_norm_stats", "instance_norm_apply", "instance_norm_bwd_sums", "instance_norm_bwd_apply")
MID_CRITERION = {"task": "multilabel", "lambda_dice": 1.0, "lambda_ce": 1.0, "include_background": True,
                 "squared_pred": False, "jaccard": False, "sigmoid": True}


def sp_config(save_dir: str, dtype: str, world: int) -> dict:
    """The HECKTOR21 recipe (``train_recipe``) for phase 23: one epoch,
    ``training.devices`` with card 0 for each of the ``world`` ranks, a
    ``data=1 x space=world`` mesh, ``compute_dtype``."""
    cfg = train_recipe(save_dir)
    cfg["training"].update({"epochs": 1, "compute_dtype": dtype, "devices": [0] * world, "batch_size": TRAIN_BATCH,
                            "mesh": {"data": 1, "space": world}})
    return cfg


def sp_data(shape, mid_shape) -> dict:
    """Phase 23's volumes (from seeds): the training set (Tent and evaluation
    reuse its volumes), the validation batch, the mid-fusion batch, the
    other models' HECKTOR21 and BraTS volumes (the first of the training
    set's and the mid-fusion batch's)."""
    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes

    train = hecktor_volumes(SP_STEPS * TRAIN_BATCH, SP_TRAIN_SEED, shape)
    mid = brats_volumes(SP_MID_BATCH, tuple(mid_shape), seed=232)
    return {"train": train, "val": hecktor_volumes(SP_VAL, 231, shape), "mid": mid,
            "sm_hecktor": train[:SM_HECKTOR_VOLUMES], "sm_brats": mid[:1]}


def split_counts() -> dict:
    """The norm kernels' launch counters, the split entries' included."""
    import importlib

    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus

    fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")

    out = {"forward": fin.fused_instance_norm.launches, "backward": fin.fused_instance_norm.backward_launches,
           "minplus": minplus.launches, "plain_backward": fin.instance_norm_backward_plain.cuda_calls}
    out.update({name: getattr(fin, name).launches for name in SPLIT_ENTRIES})
    return out


def sp_run(device, root: str, mesh, spec: dict) -> dict:
    """Phase 23's main path in this process: over the ranks of ``mesh``
    (data 1 x space 2), or in one process (``mesh`` None) on the same global
    batches. The flagship in f32 through ``ExperimentManager`` (the
    replicated device cache: each rank stages its depth slab), one
    validation batch, Tent online and strict on global batches of 2,
    ``TTAEngine.evaluate`` with continual Tent; one f32 training step of the
    mid-fusion UNet with remat; the launches of each part; each split norm
    entry against its plain version at every call of that path
    (``SplitCheck``), the peak memory; then bf16 timing of the flagship's
    training and Tent steps, the entries held the same way in the first
    (cold) step of each."""
    import torch

    import multimodal_tta_tpu_torch.ops.surface as surface_module
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.data import get_seg_transforms
    from multimodal_tta_tpu_torch.data.device_cache import DeviceCachedLoader
    from multimodal_tta_tpu_torch.kernels.edt_minplus import squared_edt_volumes, squared_edt_volumes_plain
    from multimodal_tta_tpu_torch.models.unet_multimodal_midfusion import MultimodalUNetMidFusion
    from multimodal_tta_tpu_torch.parallel.mesh import Mesh
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_part, parts = time.perf_counter(), {}

    def part(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    shape = tuple(spec["shape"])
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    rank = mesh.rank if mesh is not None else 0
    tag = f"rank{rank}" if mesh is not None else "one"
    world = SP_WORLD if mesh is not None else 1
    one_mesh = mesh if mesh is not None else Mesh(dev)
    data = torch.load(spec["data"], weights_only=False)
    data["tent"] = data["train"][:(2 * SP_TENT_BATCHES + SP_TIMED) * BATCH]
    data["eval"] = data["train"][-sum(SP_EVAL_SIZES):]
    spec_t = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                                image_size=shape, intensity_policy=HECKTOR_POLICY, channel_names=["ct", "pt"],
                                on_device=True).device_spec()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def since(at: dict) -> dict:
        now = split_counts()
        return {k: now[k] - at[k] for k in now}

    def local(x):
        return x if mesh is None else mesh.local(x)

    def gather(t):
        return t if mesh is None else mesh.gather(t)

    class Steps(HookBase):
        """Each step's global loss, the first step's gradients (summed over
        the ranks) and, with ``timed``, its ms."""

        def __init__(self, timed: bool):
            self.timed, self.losses, self.ms, self.grads, self.check = timed, [], [], None, None

        def before_train_step(self):
            if self.check is not None:
                self.check.on = not self.ms
            if self.timed:
                sync()
                self._t = time.perf_counter()

        def after_train_step(self):
            self.losses.append(self.trainer._pending_loss)
            if self.grads is None and not self.timed:
                self.grads = {n: p.grad.detach().cpu().clone()
                              for n, p in self.trainer.state.model.named_parameters() if p.grad is not None}
            if self.timed:
                sync()
                self.ms.append((time.perf_counter() - self._t) * 1e3)

    def manager(dtype: str, sub: str, timed: bool):
        cfg = sp_config(os.path.join(root, f"{tag}_{sub}"), dtype, world)
        cfg["model"]["channels"] = list(spec["channels"])
        cfg["training"]["model_save_start"] = 10**6
        if timed:
            cfg["training"]["eval_test"]["do_val"] = False
        m = ExperimentManager(ConfigNode(cfg), device=dev, mesh=one_mesh)
        m.setup_model()
        m.setup_optimizer()
        m.setup_scheduler()
        # the replicated store: one process's order on every rank; a rank
        # stages its depth slab of every volume
        m.train_loader = DeviceCachedLoader(data["train"], batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                                            seed=0, device=dev, num_workers=4, mesh=mesh)
        m.val_loader = [_stack(data["val"])]
        m.device_transform = spec_t
        m.setup_trainer(os.path.join(root, f"{tag}_{sub}"))
        steps = Steps(timed)
        m.trainer.register_hooks([steps])
        return m, steps

    out = {"tag": tag, "rank": rank, "device": str(dev)}

    def peak_from_here():
        """Start a peak-memory window; its reading counts only what this
        run allocates above what was live at the start (the whole smoke's
        one process still holds earlier phases' tensors)."""
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)

    def peak_gib(base):
        return (torch.cuda.max_memory_allocated(dev) - base) / 2**30

    base = peak_from_here() if cuda else 0
    val_edt = []

    def recording_edt(pts, spacing, *, sqrt=False):
        got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        val_edt.append((pts.clone(), spacing, sqrt, got.clone()))
        return got

    m, steps = manager("float32", "f32", timed=False)
    model = m.model
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    check = SplitCheck()
    surface_module.squared_edt_volumes = recording_edt
    try:
        check.__enter__()
        part("setup")
        at = split_counts()
        with NormLevels(model) as levels:
            history = m.train(1)
        sync()
        out["launches"] = {"train": since(at)}
        part("train_and_validation")
        out["losses"] = [float(v) for v in steps.losses]
        out["val"] = history["eval_history"][0]
        out["grads"] = steps.grads
        out["norms"] = {"split": len(levels.split), "whole": len(levels.whole)}
        out["store_shape"] = list(m.train_loader._images.shape)

        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        tent = [_stack(data["tent"][i * BATCH:(i + 1) * BATCH])["image"] for i in range(2 * SP_TENT_BATCHES)]
        source = {n: p.detach().clone() for n, p in model.named_parameters()}
        norm = [n for n, k in norm_param_mask(model).items() if k]
        out["tent"] = {}
        for mode, episodic, batches in (("inline", False, tent[:SP_TENT_BATCHES]),
                                        ("post", True, tent[SP_TENT_BATCHES:])):
            cfg = ConfigNode(eval_config("tent", episodic))
            ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
            fn = ad.make_adapt_predict_fn(model, THRESHOLD, mode)
            at = split_counts()
            preds, ents = [], []
            for x in batches:
                _, pred = fn(model, torch.from_numpy(local(x)), x.shape[0])
                preds.append(gather(pred).cpu())
                ents.append(ad._last_ents.cpu())
            sync()
            out["launches"][f"tent_{mode}"] = since(at)
            adapted = {n: dict(model.named_parameters())[n].detach().cpu().clone() for n in norm}
            ad.restore()
            out["tent"][mode] = {"ents": [e.tolist() for e in ents], "preds": preds if rank == 0 else None,
                                 "adapted": adapted}
        part("tent")
        out["source_norm"] = {n: source[n].cpu() for n in norm}

        ev, i0 = [], 0
        for b in SP_EVAL_SIZES:
            ev.append(_stack(data["eval"][i0:i0 + b]))
            i0 += b
        engine = TTAEngine(ConfigNode(eval_config("tent", False)), device_transform=DEVICE_TRANSFORM, device=dev,
                           mesh=mesh)
        at = split_counts()
        out["eval"] = engine.evaluate(model, ev)
        sync()
        out["launches"]["evaluate"] = since(at)
        part("evaluate")
        out["peak_gib"] = peak_gib(base) if cuda else None
        del m, model, engine
        if cuda:
            torch.cuda.empty_cache()
            base = peak_from_here()

        # the mid-fusion UNet: one f32 training step of the BraTS recipe with remat
        mcfg = ConfigNode({"task": {"seed": 0}, "training": {
            "optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}}, "remat": True,
            "criterion": MID_CRITERION, "compute_dtype": "float32",
            "param_groups": {"no_decay_keys": ["bias", "norm", "scale"], "treat_1d_as_no_decay": True}}})
        mid = MultimodalUNetMidFusion(channels=tuple(spec["mid_channels"]), remat=True, device=dev, seed=5)
        optimizer, lr = build_optimizer(mcfg.training, mid, mesh)
        trainer = SegTrainer(mcfg, device_transform={"normalize": False}, device=dev, mesh=one_mesh)
        trainer.setup(TrainState(model=mid, optimizer=optimizer), None, EpochScheduler(mcfg.training, lr))
        grads = {}

        def keep():
            grads.update({n: p.grad.detach().cpu().clone() for n, p in mid.named_parameters() if p.grad is not None})
            return False

        trainer.state.apply_gradients = keep
        batch = _stack(data["mid"])
        at = split_counts()
        with NormLevels(mid) as levels:
            trainer.run_step({"image": batch["image"], "label": batch["label"]})
        out["mid"] = {"loss": trainer.flush_step_metrics()["loss"], "grads": grads}
        sync()
        out["launches"]["mid_train"] = since(at)
        # norm calls over a split depth a forward: the one fusion norm runs once per modality
        fusion = [mod for mod in mid.fusion_layer.modules() if mod in levels.split]
        out["mid"]["norms"] = len(levels.split) + (mid.num_modalities - 1) * len(fusion)
        out["mid_peak_gib"] = peak_gib(base) if cuda else None
        del mid, trainer, optimizer
        part("mid_train")
        if cuda:
            torch.cuda.empty_cache()
        out["models"] = sm_run(dev, root, mesh, one_mesh, spec, data, {
            "sync": sync, "since": since, "local": local, "gather": gather, "peak_from_here": peak_from_here,
            "peak_gib": peak_gib, "check": check, "teacher": spec["teacher"]})
        part("space_models")
    finally:
        check.__exit__(None, None, None)
        surface_module.squared_edt_volumes = squared_edt_volumes
    # the f32 path's split calls, each held to its plain version as it ran;
    # its EDTs against theirs
    out["kernel_check"] = {"split": dict(check.seen), "split_ok": mesh is None or check.ok(),
                           "edt_bitwise": [bool(torch.equal(o, squared_edt_volumes_plain(p, s, sqrt=q)))
                                           for p, s, q, o in val_edt]}
    val_edt.clear()
    if cuda:
        torch.cuda.empty_cache()

    # ---- bf16 timing: the recipe's training step and the Tent step ----------------
    if spec.get("timed", cuda):
        base = peak_from_here()
        mb, tsteps = manager("bfloat16", "bf16", timed=True)
        bcheck = SplitCheck()
        tsteps.check = bcheck  # on for the first (cold) step alone
        with CollectiveBytes() as coll, bcheck:
            mb.train(1)
        out["collectives_per_train_step"] = {k: {"calls": coll.calls[k] / len(tsteps.ms),
                                                 "bytes": coll.bytes[k] / len(tsteps.ms)} for k in coll.calls}
        cfg = ConfigNode(eval_config("tent", False))
        ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
        fn = ad.make_adapt_predict_fn(mb.model, THRESHOLD, "inline")
        tent_ms = []
        with CollectiveBytes() as coll, bcheck:
            for i in range(SP_TIMED):
                x = _stack(data["tent"][(2 * SP_TENT_BATCHES + i) * BATCH:
                                        (2 * SP_TENT_BATCHES + i + 1) * BATCH])["image"]
                bcheck.on = i == 0
                sync()
                t1 = time.perf_counter()
                fn(mb.model, torch.from_numpy(local(x)), x.shape[0])
                sync()
                tent_ms.append((time.perf_counter() - t1) * 1e3)
        out["collectives_per_tent_step"] = {k: {"calls": coll.calls[k] / SP_TIMED, "bytes": coll.bytes[k] / SP_TIMED}
                                            for k in coll.calls}
        out["timing"] = {"train_step_ms": tsteps.ms, "tent_step_ms": tent_ms, "peak_gib": peak_gib(base)}
        out["kernel_check"]["split_bf16"] = dict(bcheck.seen)
        out["kernel_check"]["split_ok"] &= mesh is None or bcheck.ok(("bfloat16",))
        del mb
        torch.cuda.empty_cache()
        part("bf16_timing")
    out["part_s"] = parts
    return out


# ---- phase 23, the other models, norms and training options over space ----
# each case at full width on the two ranks against one process (f32, TF32
# off): late fusion with remat on [1,160,192,160,4] (a step, a strict Tent
# step), UNet3D-WS distilled from a flagship teacher on [2,48,144,144,2] (two
# steps, an evaluated batch), SegResNet (GROUP; a step, TTAEngine.evaluate
# with continual Tent), the BatchNorm flagship (a step, an online Tent step,
# TTAEngine.evaluate with norm), the flagship with deep supervision 2 and 4
# bottleneck experts on [1,160,192,160,4] (its bottleneck split: 5 planes a
# rank; one step), the flagship with GWDL (one step); each split norm call
# held to its plain version as it runs (SplitCheck), each EDT bitwise; then
# each model's bf16 training step timed (one cold, one warm)
SM_CASES = ("late", "ws_distill", "segresnet", "batchnorm", "ds_moe", "gwdl")
SM_HECKTOR_VOLUMES = 4
SM_SEED = 233
SM_TIMED = 2  # bf16 training steps a model (the first cold)
# SegResNet's f32 gradients are ill-conditioned at its stem: one process's
# own step moves them 2.03e-4 when only its group norms' sums are reordered
# (tests/test_torch_space_models.py's witness at test size), so its limit is
# the mid-fusion step's; the BatchNorm flagship's likewise: on another batch
# one process's step moves 1.28e-4 when only its statistics' sums are taken
# over half-depth slabs, as the ranks' (scripts/torch_space_parallel.py
# --witnesses), where phase 23's batch sits 2.5e-6 apart
SM_GRAD_REL = {"segresnet": SP_MID_GRAD_REL, "batchnorm": SP_MID_GRAD_REL}
GWDL_CRITERION = {"name": "gwdl", "softmax": True, "sigmoid": False, "lambda_ce": 1.0,
                  "distance_matrix": [[0.0, 1.0], [1.0, 0.0]]}


def model_node(name: str, **overrides) -> dict:
    """``configs/model/<name>.yaml`` (its ``defaults`` dropped) with
    ``overrides``."""
    from multimodal_tta_tpu_torch.conf import yaml_subset

    with open(os.path.join(REPO, "configs", "model", f"{name}.yaml"), encoding="utf-8") as f:
        node = yaml_subset.load(f.read())
    node.pop("defaults", None)
    node.update(overrides)
    return node


def sm_config(model: dict, criterion: dict, dtype: str, **training) -> dict:
    """A SegTrainer config: SGD (lr 1e-2, momentum 0.9) outside the no-decay
    groups, ``criterion``, the compute dtype, ``model``."""
    t = {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}}, "criterion": criterion,
         "compute_dtype": dtype, "param_groups": {"no_decay_keys": ["bias", "norm", "scale"],
                                                  "treat_1d_as_no_decay": True}}
    t.update(training)
    return {"task": {"seed": 0}, "training": t, "model": model}


def sm_specs(spec: dict, teacher: str) -> dict:
    """Each case: its model node, criterion, device transform, data key and
    the training options."""
    shape = list(spec["shape"])
    chans = list(spec["channels"])
    flagship = model_node("unet", channels=chans)
    out = {
        "late": dict(model=model_node("unet_multimodal_late", channels=list(spec["mid_channels"])), remat=True,
                     criterion=MID_CRITERION, transform={"normalize": False}, data="brats"),
        "ws_distill": dict(model=dict(flagship, name="unet_ws"), data="hecktor", transform=DEVICE_TRANSFORM,
                           distill={"enabled": True, "checkpoint": teacher, "temperature": 2.0, "weight": 0.5,
                                    "focus": "uncertain", "model": flagship},
                           image_size=shape),
        "segresnet": dict(model=model_node("segresnet", init_filters=spec["init_filters"]), data="hecktor",
                          transform=DEVICE_TRANSFORM),
        "batchnorm": dict(model=dict(flagship, norm="BATCH"), data="hecktor", transform=DEVICE_TRANSFORM),
        "ds_moe": dict(model=dict(model_node("unet", channels=list(spec["mid_channels"])), in_channels=4,
                                  num_classes=3, deep_supervision=2, moe_experts=4),
                       criterion=MID_CRITERION, transform={"normalize": False}, data="brats"),
        "gwdl": dict(model=dict(flagship, num_classes=2), criterion=GWDL_CRITERION, data="hecktor_map",
                     transform=DEVICE_TRANSFORM),
    }
    return out


def sm_teacher(path: str, channels) -> str:
    """The distillation teacher: a flagship UNet3D at ``channels`` from a
    seed, written as the port's checkpoint at ``path`` (on the CPU)."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    model = UNet3D.from_config(ConfigNode(model_node("unet", channels=list(channels))), device="cpu", seed=SM_SEED + 2)
    save_checkpoint(path, TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)))
    return path


def sm_batches(data: dict, key: str) -> list:
    """The case's global host batches: BraTS volumes one at a time, HECKTOR
    volumes two at a time (class maps for GWDL)."""
    if key == "brats":
        return [_stack(data["sm_brats"])]
    vols = data["sm_hecktor"]
    out = [_stack(vols[i:i + 2]) for i in range(0, len(vols), 2)]
    if key == "hecktor_map":
        for b in out:
            b["label"] = b["label"][..., 0].astype("int64")
    return out


def sm_run(dev, root: str, mesh, one_mesh, spec: dict, data: dict, tools: dict) -> dict:
    """The other models, norms and training options over the space axis
    (``SM_CASES``) in this process: over the ranks of ``mesh``, or in one
    process on the same global batches. Per case: the losses, the first
    step's gradients, the running statistics, the MoE scalars, Tent's
    entropies and adapted tensors, the evaluated metrics, the norms that ran
    split and whole (``NormLevels``), each part's launches, the peak memory
    and the f32 step ms; then the bf16 training steps' ms (``tools["check"]``
    off for them)."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.models.layers import running_statistics
    from multimodal_tta_tpu_torch.registry import get_model
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    sync, since, local = tools["sync"], tools["since"], tools["local"]
    cuda = dev.type == "cuda"
    specs = sm_specs(spec, tools["teacher"])
    recipe_criterion = train_recipe(os.path.join(root, "recipe"))["training"]["criterion"]
    out = {}

    def build(case: dict, dtype: str):
        criterion = case.get("criterion", recipe_criterion)
        extra = {}
        if "distill" in case:
            extra = {"distill": case["distill"], "data": {"transforms": {"image_size": case["image_size"]}}}
        cfg = ConfigNode(sm_config(case["model"], criterion, dtype, remat=case.get("remat", False), **extra))
        model = get_model(case["model"]["name"]).from_config(
            cfg.model, dtype=getattr(torch, dtype), remat=case.get("remat", False), device=dev, seed=SM_SEED)
        optimizer, lr = build_optimizer(cfg.training, model, one_mesh)
        trainer = SegTrainer(cfg, device_transform=case["transform"], device=dev, mesh=one_mesh)
        trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
        return cfg, model, trainer

    def train(trainer, batches, grads=None):
        """``run_step`` on each batch: losses, each step's ms; the first
        step's gradients into ``grads`` (a dict)."""
        apply = trainer.state.apply_gradients

        def first():
            grads.update({n: p.grad.detach().cpu().clone() for n, p in trainer.state.model.named_parameters()
                          if p.grad is not None})
            trainer.state.apply_gradients = apply
            return apply()

        if grads is not None:
            trainer.state.apply_gradients = first
        losses, ms = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            trainer.run_step({"image": b["image"], "label": b["label"]})
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(trainer.flush_step_metrics()["loss"])
        return losses, ms

    for name in SM_CASES:
        case = specs[name]
        batches = sm_batches(data, case["data"])
        base = tools["peak_from_here"]() if cuda else 0
        cfg, model, trainer = build(case, "float32")
        r = {"launches": {}}
        grads = {}
        steps = batches[:1] if name in ("late", "segresnet", "batchnorm", "ds_moe", "gwdl") else batches
        at = split_counts()
        with NormLevels(model) as levels:
            if trainer.distill.enabled:
                trainer.prepare()
                with NormLevels(trainer.teacher) as tlevels:
                    r["losses"], r["f32_ms"] = train(trainer, steps, grads)
                r["teacher_norms"] = {"split": len(tlevels.split), "whole": len(tlevels.whole)}
            else:
                r["losses"], r["f32_ms"] = train(trainer, steps, grads)
        sync()
        r["launches"]["train"] = since(at)
        r["norms"] = {"split": len(levels.split), "whole": len(levels.whole)}
        r["first_norms"] = 4 if name == "late" else 1  # norms whose input needs no gradient in a Tent step
        r["grads"] = grads
        r["stats"] = {k: v.cpu() for k, v in running_statistics(model).items()}
        if trainer.moe_stats is not None:
            r["moe"] = {k: v.cpu().tolist() for k, v in trainer.moe_stats.items()}
        norm = [n for n, k in norm_param_mask(model).items() if k]
        if name in ("late", "batchnorm"):
            # a Tent step: late fusion strict (episodic, post), the BN flagship online
            tcfg = ConfigNode(eval_config("tent", name == "late"))
            ad = TentAdapter(tcfg.tta, config=tcfg, device_transform=case["transform"], device=dev, mesh=mesh)
            fn = ad.make_adapt_predict_fn(model, THRESHOLD if name == "batchnorm" else 0.5,
                                          "post" if name == "late" else "inline")
            before = {n: p.detach().clone() for n, p in model.named_parameters() if n in norm}
            at = split_counts()
            _, pred = fn(model, torch.from_numpy(local(batches[0]["image"])), batches[0]["image"].shape[0])
            sync()
            r["launches"]["tent"] = since(at)
            r["tent"] = {"ents": ad._last_ents.cpu().tolist(),
                         "moved": {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters() if n in norm},
                         "stats": {k: v.cpu() for k, v in running_statistics(model).items()},
                         "preds": tools["gather"](pred).cpu()}
            ad.restore()
        evals = {"ws_distill": "none", "segresnet": "tent", "batchnorm": "norm"}
        if name in evals:
            method = evals[name]
            ecfg = ConfigNode(eval_config(method, False))
            engine = TTAEngine(ecfg, device_transform=case["transform"], device=dev, mesh=mesh)
            at = split_counts()
            r["eval"] = engine.evaluate(model, batches[-1:])
            sync()
            r["launches"]["evaluate"] = since(at)
        r["peak_gib"] = tools["peak_gib"](base) if cuda else None
        del model, trainer
        if cuda:
            torch.cuda.empty_cache()
        out[name] = r

    if spec.get("timed", cuda):
        tools["check"].on = False
        for name in SM_CASES:
            case = specs[name]
            base = tools["peak_from_here"]()
            _, _, trainer = build(case, "bfloat16")
            batches = sm_batches(data, case["data"])
            _, ms = train(trainer, (batches * SM_TIMED)[:SM_TIMED])
            out[name]["bf16_ms"] = ms
            out[name]["bf16_peak_gib"] = tools["peak_gib"](base)
            del trainer
            torch.cuda.empty_cache()
        tools["check"].on = True
    return out


def sm_expected(res: dict, cuda: bool) -> dict:
    """Each case's launches by part, derived from the norms that ran split
    and whole (``res["norms"]``): a forward takes the one-launch kernel for
    each whole norm and stats + apply for each split one, a training
    backward bwd_sums + bwd_apply for each split norm and the backward
    kernel for each whole one, a Tent backward no bwd_apply for the norms
    whose input needs no gradient (``first_norms``: each tower's first);
    remat runs each training forward twice; a distilled step adds the
    teacher's forward; each evaluated batch one min-plus launch."""
    out = {}
    for name, r in res.items():
        s, w = (r["norms"]["split"], r["norms"]["whole"]) if cuda else (0, 0)
        ts, tw = (r["teacher_norms"]["split"], r["teacher_norms"]["whole"]) if cuda and "teacher_norms" in r \
            else (0, 0)
        first = r["first_norms"]

        def launches(fwd=0, bwd=0, tent_bwd=0, minplus=0, teacher=0):
            return {"forward": w * fwd + tw * teacher, "backward": w * (bwd + tent_bwd),
                    "minplus": minplus * int(cuda), "plain_backward": 0,
                    "instance_norm_stats": s * fwd + ts * teacher, "instance_norm_apply": s * fwd + ts * teacher,
                    "instance_norm_bwd_sums": s * (bwd + tent_bwd),
                    "instance_norm_bwd_apply": s * bwd + max(s - first, 0) * tent_bwd}

        steps = len(r["losses"])
        remat = 2 if name == "late" else 1
        want = {"train": launches(fwd=remat * steps, bwd=steps, teacher=steps if "teacher_norms" in r else 0)}
        if "tent" in r:
            # strict: the step's forward (twice under remat) and the post-update forward
            want["tent"] = launches(fwd=remat + 1 if name == "late" else 1, tent_bwd=1)
        if "eval" in r:
            tent = name == "segresnet"
            want["evaluate"] = launches(fwd=2 if tent else 1, tent_bwd=int(tent), minplus=1)
        out[name] = want
    return out


def sm_compare(one: dict, ranks: list) -> dict:
    """The ranks' cases against one process's: losses, the first step's
    gradients (summed over the ranks), running statistics, MoE scalars,
    Tent's entropies, moves and predictions, evaluated metrics; each rank
    alike. Every check is made before a failure raises."""
    import torch

    out, failed = {}, []
    for name, o in one.items():
        r0 = ranks[0][name]
        c = {}
        c["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], o["losses"]))
        c["losses"] = [r0["losses"], o["losses"]]
        c["grad_rel_l2"] = _grad_rel(r0["grads"], o["grads"])
        c["most_apart"] = sorted(((_grad_rel({n: r0["grads"][n]}, {n: o["grads"][n]}), n) for n in o["grads"]),
                                 reverse=True)[:3]
        limit = SM_GRAD_REL.get(name, SP_GRAD_REL)
        if c["loss_rel"] > SP_LOSS_REL or c["grad_rel_l2"] > limit or sorted(r0["grads"]) != sorted(o["grads"]):
            failed.append(f"{name} training: {c}")
        if any(res[name]["losses"] != r0["losses"] for res in ranks):
            failed.append(f"{name}: the ranks' losses differ")
        if o["stats"]:
            c["stats_rel"] = max(float((r0["stats"][k] - v).norm() / v.norm().clamp(min=1e-30))
                                 for k, v in o["stats"].items())
            if c["stats_rel"] > SP_GRAD_REL or any(not torch.equal(res[name]["stats"][k], r0["stats"][k])
                                                   for res in ranks for k in r0["stats"]):
                failed.append(f"{name}: running statistics {c['stats_rel']}")
        if "moe" in o:
            c["moe"] = [r0["moe"], o["moe"]]
            if any(abs(a - b) > 1e-5 * abs(b) + 1e-7 for k in o["moe"] for a, b in zip(r0["moe"][k], o["moe"][k])):
                failed.append(f"{name}: MoE scalars {c['moe']}")
        if "tent" in o:
            t, ot = r0["tent"], o["tent"]
            keys = sorted(ot["moved"])
            diff = torch.cat([(t["moved"][k] - ot["moved"][k]).flatten() for k in keys])
            ref = torch.cat([ot["moved"][k].flatten() for k in keys])
            c["tent"] = {"ents_max_rel": max(abs(a - b) / abs(b) for a, b in zip(t["ents"], ot["ents"])),
                         "delta_rel_l2": float(diff.norm() / ref.norm()),
                         "pred_agree": float((t["preds"] == ot["preds"]).float().mean())}
            if ot["stats"]:
                c["tent"]["stats_rel"] = max(float((t["stats"][k] - v).norm() / v.norm().clamp(min=1e-30))
                                             for k, v in ot["stats"].items())
            if c["tent"]["ents_max_rel"] > SP_LOSS_REL or c["tent"]["delta_rel_l2"] > SP_DELTA_REL \
                    or c["tent"]["pred_agree"] < SP_PRED_AGREE or c["tent"].get("stats_rel", 0.0) > SP_GRAD_REL:
                failed.append(f"{name} Tent: {c['tent']}")
        if "eval" in o:
            e0 = r0["eval"]
            c["eval_max_abs"] = max(abs(e0[k] - v) for k, v in o["eval"].items() if isinstance(v, float))
            if set(e0) != set(o["eval"]) or any(abs(e0[k] - v) > DP_METRIC_ABS + DP_METRIC_REL * abs(v)
                                                for k, v in o["eval"].items() if isinstance(v, float)) \
                    or any(res[name]["eval"] != e0 for res in ranks):
                failed.append(f"{name} evaluation: {e0} vs {o['eval']}")
        out[name] = c
    if failed:
        raise AssertionError("phase 23 (models), two ranks vs one process: " + "; ".join(failed) + f"; all: {out}")
    return out


class NormLevels:
    """Inside the block, the instance norms of ``model`` that ran over a
    split depth (given a level's space axis) and those that ran whole, by
    forward pre-hooks."""

    def __init__(self, model):
        self.model, self.split, self.whole = model, set(), set()

    def __enter__(self):
        from multimodal_tta_tpu_torch.models.layers import InstanceNorm

        def seen(mod, args, kwargs):
            (self.split if kwargs.get("space") is not None else self.whole).add(mod)

        self._hooks = [mod.register_forward_pre_hook(seen, with_kwargs=True) for mod in self.model.modules()
                       if isinstance(mod, InstanceNorm)]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        return False


class CollectiveBytes:
    """Inside the block, count this process's ``all_gather`` and
    ``all_reduce`` calls and the bytes each sends (its own tensor), by
    wrapping ``torch.distributed``'s two functions (the port calls them
    through the module)."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls = {"all_gather": 0, "all_reduce": 0}
        self.bytes = {"all_gather": 0, "all_reduce": 0}
        self._orig = (dist.all_gather, dist.all_reduce)

        def gather(parts, t, *a, **k):
            self.calls["all_gather"] += 1
            self.bytes["all_gather"] += t.numel() * t.element_size()
            return self._orig[0](parts, t, *a, **k)

        def reduce(t, *a, **k):
            self.calls["all_reduce"] += 1
            self.bytes["all_reduce"] += t.numel() * t.element_size()
            return self._orig[1](t, *a, **k)

        dist.all_gather, dist.all_reduce = gather, reduce
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_gather, dist.all_reduce = self._orig
        return False


SPLIT_CHECK_BYTES = 512 << 20  # a check's plain version runs on slices of at most this many f32 bytes
SPLIT_KEYS = {"instance_norm_stats": "stats", "instance_norm_apply": "apply", "instance_norm_bwd_sums": "bwd_sums",
              "instance_norm_bwd_apply": "bwd_apply"}


def _slices(x):
    """(b, depth slice) of ``x`` [B, D, H, W, C], each at most
    SPLIT_CHECK_BYTES of f32."""
    k = max(1, SPLIT_CHECK_BYTES // (x[0, 0].numel() * 4))
    for b in range(x.shape[0]):
        for d0 in range(0, x.shape[1], k):
            yield b, slice(d0, min(d0 + k, x.shape[1]))


def _sums_check(got, want, slack=None) -> tuple:
    """f32 [2, B, C] sums: (max |error|, its largest share of the limit
    GRAD_F32_REL * max |want| + GRAD_F32_ABS (+ ``slack``))."""
    diff = (got - want).abs()
    lim = GRAD_F32_REL * want.abs().max() + GRAD_F32_ABS
    if slack is not None:
        lim = lim + slack
    return diff.max(), (diff / lim).max()


def _kink(x, gamma, beta, stats, b, d, relu: bool):
    """The elements of ``x[b, d]`` within KINK_MARGIN of the ReLU's kink
    (there the mask rightly depends on the summation order), and xhat."""
    import torch

    shp = (1, 1, 1, 1, x.shape[-1])
    xhat = (x[b:b + 1, d].float() - stats[0, b].view(shp)) * stats[1, b].view(shp)
    kink = (xhat * gamma + beta).abs() < KINK_MARGIN if relu else torch.zeros_like(xhat, dtype=torch.bool)
    return kink, xhat


def check_split_entry(key: str, args: tuple, got) -> dict:
    """Split norm entry ``key`` (stats, apply, bwd_sums, bwd_apply) given
    ``args`` (its operator's arguments) returned ``got``: its plain version
    on the same arguments, one slice at a time (``_slices``), so the check
    holds at most a slice's temporaries. Limits by the input's dtype, as
    phase 2 holds the one-launch kernel: the f32 sums and statistics relative
    to their largest value (GRAD_F32_*); y within TOL_F32 / TOL_BF16; dx
    within phase 2's f32 limit / DX_BF16_REL. The ReLU's kink: a backward
    sum may take the output gradient of an element within KINK_MARGIN of it
    either way (its limit widens by those elements' |gy| and |gy * xhat|),
    and dx is held elsewhere. Returns the max |error|, ``worst`` (its
    largest share of the limit: the entry passes at <= 1), the elements at
    the kink."""
    import importlib

    import torch

    fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
    zero = torch.zeros((), device=got[0].device if isinstance(got, tuple) else got.device)
    err, worst, kinks = zero.clone(), zero.clone(), 0
    if key == "stats":
        (x,) = args
        want = torch.zeros_like(got)
        for b, d in _slices(x):
            want[:, b] += fin.instance_norm_stats_plain(x[b:b + 1, d])[:, 0]
        err, worst = _sums_check(got, want)
    elif key == "apply":
        x, gamma, beta, sums, n, eps, relu = args
        y, stats = got
        tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
        want_stats = torch.zeros_like(stats)
        for b, d in _slices(x):
            y_p, st = fin.instance_norm_apply_plain(x[b:b + 1, d], gamma, beta, sums[:, b:b + 1], n, eps, relu)
            diff = (y[b:b + 1, d].float() - y_p.float()).abs()
            err = torch.maximum(err, diff.max())
            worst = torch.maximum(worst, ((diff - tol["rtol"] * y_p.float().abs()) / tol["atol"]).max())
            want_stats[:, b] = st[:, 0]
        if y.dtype != x.dtype or y.shape != x.shape:
            worst = zero + float("inf")
        e2, w2 = _sums_check(stats, want_stats)
        err, worst = torch.maximum(err, e2), torch.maximum(worst, w2)
    elif key == "bwd_sums":
        gy, x, gamma, beta, stats, relu = args
        want, slack = torch.zeros_like(got), torch.zeros_like(got)
        for b, d in _slices(x):
            g, xhat = fin._masked_grad(gy[b:b + 1, d], x[b:b + 1, d], gamma, beta, stats[:, b:b + 1], relu)
            want[0, b] += g.sum(dim=(0, 1, 2, 3))
            want[1, b] += (g * xhat).sum(dim=(0, 1, 2, 3))
            kink, _ = _kink(x, gamma, beta, stats, b, d, relu)
            a = gy[b:b + 1, d].float().abs() * kink
            slack[0, b] += a.sum(dim=(0, 1, 2, 3))
            slack[1, b] += (a * xhat.abs()).sum(dim=(0, 1, 2, 3))
            kinks += int(kink.sum())
        err, worst = _sums_check(got, want, slack)
    elif key == "bwd_apply":
        gy, x, gamma, beta, stats, sums, n, relu = args
        dx = got
        vmax, excess = zero.clone(), zero - float("inf")
        for b, d in _slices(x):
            ref = fin.instance_norm_bwd_apply_plain(gy[b:b + 1, d], x[b:b + 1, d], gamma, beta, stats[:, b:b + 1],
                                                     sums[:, b:b + 1], n, relu).float()
            kink, _ = _kink(x, gamma, beta, stats, b, d, relu)
            diff = torch.where(kink, 0.0, (dx[b:b + 1, d].float() - ref).abs())
            kinks += int(kink.sum())
            err = torch.maximum(err, diff.max())
            vmax = torch.maximum(vmax, ref.abs().max())
            if x.dtype == torch.bfloat16:  # diff <= REL * (vmax + |ref|)
                excess = torch.maximum(excess, (diff - DX_BF16_REL * ref.abs()).max())
        if x.dtype == torch.bfloat16:
            worst = excess / (DX_BF16_REL * vmax)
        else:
            worst = err / (GRAD_F32_REL * vmax + GRAD_F32_ABS)
        if dx.dtype != x.dtype or dx.shape != x.shape:
            worst = zero + float("inf")
    else:
        raise ValueError(f"no split entry {key!r}")
    return {"err": float(err), "worst": float(worst), "kink": kinks}


class SplitCheck:
    """While ``on``, every call that the main path makes to a split norm
    entry (the four operators ``kernels/fused_instance_norm.py:_SplitNorm``
    calls) is held against the entry's plain version on the same arguments,
    the path's own output gradient included (``check_split_entry``); the
    kernel's result goes on down the path. The check launches no kernel, so
    the path's launch counts stay its own. Per entry and input dtype: the
    calls checked, the max |error|, the worst share of the limit, the
    elements at the ReLU's kink."""

    OPS = {"_stats_op": "stats", "_apply_op": "apply", "_bwd_sums_op": "bwd_sums", "_bwd_apply_op": "bwd_apply"}

    def __init__(self):
        self.on, self.seen = True, {}

    def __enter__(self):
        import importlib

        self._fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
        self._orig = {name: getattr(self._fin, name) for name in self.OPS}
        for name, key in self.OPS.items():
            setattr(self._fin, name, self._wrap(self._orig[name], key))
        return self

    def __exit__(self, *exc):
        for name, op in self._orig.items():
            setattr(self._fin, name, op)
        return False

    def _wrap(self, op, key: str):
        def checked(*args):
            got = op(*args)
            if self.on:
                x = args[1] if key.startswith("bwd") else args[0]
                r = check_split_entry(key, args, got)
                s = self.seen.setdefault(f"{key} {str(x.dtype).replace('torch.', '')}",
                                         {"calls": 0, "max_abs_err": 0.0, "worst": float("-inf"), "kink": 0})
                s["calls"] += 1
                s["max_abs_err"] = max(s["max_abs_err"], r["err"])
                s["worst"] = max(s["worst"], r["worst"])
                s["kink"] += r["kink"]
            return got

        return checked

    def ok(self, dtypes=("float32",)) -> bool:
        """Every entry seen in each of ``dtypes``, each within its limit."""
        want = {f"{k} {dt}" for k in self.OPS.values() for dt in dtypes}
        return want <= set(self.seen) and all(s["worst"] <= 1.0 for s in self.seen.values())


def split_vs_plain(x, gamma, beta, n: float, act, gen) -> dict:
    """The four split entries' kernels on one input (f32 or bf16), each fed
    the previous one's result as on the path (the sums unreduced: one rank),
    against their plain versions on the same arguments
    (``check_split_entry``); the backward at a random output gradient."""
    import importlib

    import torch

    fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
    relu = act == "relu"
    sums = fin.instance_norm_stats(x)
    y, stats = fin.instance_norm_apply(x, gamma, beta, sums, n=n, relu=relu)
    gy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    gsums = fin.instance_norm_bwd_sums(gy, x, gamma, beta, stats, relu=relu)
    dx = fin.instance_norm_bwd_apply(gy, x, gamma, beta, stats, gsums, n=n, relu=relu)
    e = {"stats": check_split_entry("stats", (x,), sums),
         "apply": check_split_entry("apply", (x, gamma, beta, sums, n, 1e-5, relu), (y, stats)),
         "bwd_sums": check_split_entry("bwd_sums", (gy, x, gamma, beta, stats, relu), gsums),
         "bwd_apply": check_split_entry("bwd_apply", (gy, x, gamma, beta, stats, gsums, n, relu), dx)}
    return {"errors": {k: v["err"] for k, v in e.items()}, "worst": {k: v["worst"] for k, v in e.items()},
            "ok": all(v["worst"] <= 1.0 for v in e.values())}


def split_norm_shapes(batch: int, shape, channels, strides, space: int = SP_WORLD) -> list:
    """The split norms of one flagship forward over ``space`` ranks, per
    rank: ``[(x shape [B, D_slab, H, W, C], calls)]``. Level ``l`` (depth
    ``D_l``) is split where ``parallel/space.py:splits`` says so; its
    norms are the two of ``enc{l-1}`` (C = channels[l-1]) and the two of
    ``dec{l}`` (C = channels[l])."""
    from multimodal_tta_tpu_torch.parallel.space import splits

    dims, out = [tuple(shape)], {}
    for s in strides:
        dims.append(tuple(d // s for d in dims[-1]))
    for lvl, (d, h, w) in enumerate(dims[:-1]):
        if not splits(d, space):
            continue
        for c in ([channels[lvl - 1]] if lvl > 0 else []) + [channels[lvl]]:
            key = (batch, d // space, h, w, c)
            out[key] = out.get(key, 0) + 2
    return sorted(out.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3])


def split_kernel_table(dev, shapes: list, space: int = SP_WORLD, iters: int = 10) -> dict:
    """Each split entry against its plain version at ``shapes``
    (``split_norm_shapes``; inputs from a seed, a ReLU), in f32 and in bf16
    (``split_vs_plain``), and the ms of all the calls together (each shape's
    ms times its calls) against the plain versions' and the byte bound
    (stats reads x once; apply reads x and writes y; bwd_sums reads gy and
    x; bwd_apply reads gy and x and writes dx): f32 (the kernels line) and
    bf16 (``bf16``)."""
    import importlib

    import torch

    fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
    gen = torch.Generator(device=dev).manual_seed(123)
    moved = {"instance_norm_stats": (1, 2), "instance_norm_apply": (2, 6), "instance_norm_bwd_sums": (2, 8),
             "instance_norm_bwd_apply": (3, 10)}  # (tensors moved, operations per element)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tot = {dt: {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0.0} for k in moved}
           for dt in dtypes}
    per_shape = []
    for shp, calls in shapes:
        x32 = torch.randn(shp, generator=gen, device=dev) * 2.0 + 0.5
        g = torch.rand(shp[-1], generator=gen, device=dev) + 0.5
        b = torch.randn(shp[-1], generator=gen, device=dev) * 0.1
        n = float(shp[1] * shp[2] * shp[3] * space)
        row = {"shape": list(shp), "calls": calls, "ok": True}
        for dt, dtype in dtypes.items():
            x = x32.to(dtype)
            chk = split_vs_plain(x, g, b, n, "relu", gen)
            sums = fin.instance_norm_stats_plain(x)
            _, stats = fin.instance_norm_apply_plain(x, g, b, sums, n, 1e-5, True)
            gy = torch.randn(shp, generator=gen, device=dev).to(dtype)
            gsums = fin.instance_norm_bwd_sums_plain(gy, x, g, b, stats, True)
            runs = {
                "instance_norm_stats": (lambda: fin.instance_norm_stats(x), lambda: fin.instance_norm_stats_plain(x)),
                "instance_norm_apply": (lambda: fin.instance_norm_apply(x, g, b, sums, n=n),
                                        lambda: fin.instance_norm_apply_plain(x, g, b, sums, n, 1e-5, True)),
                "instance_norm_bwd_sums": (lambda: fin.instance_norm_bwd_sums(gy, x, g, b, stats, relu=True),
                                           lambda: fin.instance_norm_bwd_sums_plain(gy, x, g, b, stats, True)),
                "instance_norm_bwd_apply": (
                    lambda: fin.instance_norm_bwd_apply(gy, x, g, b, stats, gsums, n=n, relu=True),
                    lambda: fin.instance_norm_bwd_apply_plain(gy, x, g, b, stats, gsums, n, True)),
            }
            row[dt] = {"errors": chk["errors"], "worst": chk["worst"]}
            row["ok"] = row["ok"] and chk["ok"]
            for name, (kern, plain) in runs.items():
                ms, pms = cuda_ms(kern, iters=iters), cuda_ms(plain, iters=iters)
                o = tot[dt][name]
                o["ms"] += ms * calls
                o["plain_ms"] += pms * calls
                o["bytes"] += moved[name][0] * x.numel() * x.element_size() * calls
                o["ops"] += moved[name][1] * x.numel() * calls
                o["max_abs_err"] = max(o["max_abs_err"], chk["errors"][SPLIT_KEYS[name]])
                row[dt][name] = {"ms": ms, "plain_ms": pms}
            del x, gy, sums, stats, gsums, runs
        per_shape.append(row)
    for per_dt in tot.values():
        for o in per_dt.values():
            t_b, t_o = o["bytes"] / HBM_BYTES_PER_S * 1e3, o["ops"] / FP32_FLOPS * 1e3
            o["bound_ms"], o["bound_by"] = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
    return {"entries": tot["float32"], "bf16": tot["bfloat16"], "per_shape": per_shape,
            "ok": all(r["ok"] for r in per_shape), "calls": sum(c for _, c in shapes)}


def _sp_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """Phase 23's rank side in an initialised process group: the mesh of
    ``training.mesh`` (data 1 x space 2), ``sp_run``."""
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.parallel.mesh import mesh_from_config

    mesh = mesh_from_config(ConfigNode(sp_config(spec["ranks_root"], "float32", world)), device)
    return sp_run(device, spec["ranks_root"], mesh, spec)


def _grad_rel(a: dict, b: dict) -> float:
    import torch

    names = sorted(b)
    return float(torch.cat([(a[n] - b[n]).flatten() for n in names]).norm()
                 / torch.cat([b[n].flatten() for n in names]).norm())


def sp_compare(one: dict, ranks: list) -> dict:
    """The two-rank run against the one-process run: what agrees and by how
    much, every check made before any failure raises."""
    import torch

    r0 = ranks[0]
    out, failed = {"ranks": len(ranks)}, []
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
    out["losses"] = {"ranks": r0["losses"], "one": one["losses"], "max_rel": loss_rel}
    if any(res["losses"] != r0["losses"] for res in ranks) or loss_rel > SP_LOSS_REL:
        failed.append(f"losses {[res['losses'] for res in ranks]} vs {one['losses']}")
    g_rel = _grad_rel(r0["grads"], one["grads"])
    worst = sorted(((_grad_rel({n: r0["grads"][n]}, {n: one["grads"][n]}), n) for n in one["grads"]),
                   reverse=True)[:3]
    out["grads"] = {"rel_l2": g_rel, "most_apart": worst, "tensors": len(one["grads"])}
    if g_rel > SP_GRAD_REL or sorted(r0["grads"]) != sorted(one["grads"]) \
            or any(not all(torch.equal(res["grads"][n], r0["grads"][n]) for n in r0["grads"]) for res in ranks):
        failed.append(f"first step's gradients {out['grads']}")

    def metrics_diff(a: dict, b: dict, what: str) -> float:
        if set(a) != set(b):
            failed.append(f"{what}: keys differ")
            return float("nan")
        if any(abs(a[k] - b[k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(b[k]) for k in b if isinstance(b[k], float)):
            failed.append(f"{what}: {a} vs {b}")
        return max(abs(a[k] - b[k]) for k in b if isinstance(b[k], float))

    if any(res["val"] != r0["val"] or res["eval"] != r0["eval"] for res in ranks):
        failed.append("the ranks' metrics differ")
    out["val_max_abs"] = metrics_diff(r0["val"], one["val"], "validation")
    out["eval_max_abs"] = metrics_diff(r0["eval"], one["eval"], "TTAEngine.evaluate")
    out["tent"] = {}
    for mode, t in r0["tent"].items():
        o = one["tent"][mode]
        ent_rel = max(abs(a - b) / abs(b) for ea, eb in zip(t["ents"], o["ents"]) for a, b in zip(ea, eb))
        agree = min(float((a == b).float().mean()) for a, b in zip(t["preds"], o["preds"]))
        keys = sorted(o["adapted"])
        diff = torch.cat([(t["adapted"][k] - o["adapted"][k]).flatten() for k in keys])
        delta = torch.cat([(o["adapted"][k] - one["source_norm"][k]).flatten() for k in keys])
        rel = float(diff.norm() / delta.norm())
        out["tent"][mode] = {"ents_max_rel": ent_rel, "pred_agree": agree, "delta_rel_l2": rel}
        if any(res["tent"][mode]["ents"] != t["ents"] for res in ranks):
            failed.append(f"Tent {mode}: the ranks' entropies differ")
        if ent_rel > SP_LOSS_REL or agree < SP_PRED_AGREE or rel > SP_DELTA_REL:
            failed.append(f"Tent {mode}: {out['tent'][mode]}")
    mid_rel = abs(r0["mid"]["loss"] - one["mid"]["loss"]) / abs(one["mid"]["loss"])
    mg, og = r0["mid"]["grads"], one["mid"]["grads"]
    out["mid"] = {"loss_rel": mid_rel, "grad_rel_l2": _grad_rel(mg, og), "loss": [r0["mid"]["loss"], one["mid"]["loss"]],
                  "most_apart": sorted(((_grad_rel({n: mg[n]}, {n: og[n]}), n) for n in og), reverse=True)[:4]}
    if mid_rel > SP_LOSS_REL or out["mid"]["grad_rel_l2"] > SP_MID_GRAD_REL:
        failed.append(f"mid-fusion step {out['mid']}")
    if failed:
        raise AssertionError("phase 23, two ranks vs one process: " + "; ".join(failed) + f"; all: {out}")
    return out


# cli.predict over space: Tent and flip TTA over the depth (the flip that
# crosses the ranks; 2 forwards a batch, not 8: the lane runs beside phases
# 15-21) in f32 with the probability volumes, TF32 off in cuDNN and cuBLAS for both exports
# (NVIDIA_TF32_OVERRIDE; the CLIs keep torch's default, TF32 convolutions,
# whose algorithms differ between a half-depth slab and the whole depth:
# 121-144 voxels a case apart on an H100). In f32 the two exports' sums run
# in another order, so a voxel within rounding of the threshold may fall on
# either side (2 of 995,328 in one of 4 cases on an H100): the masks are
# held byte for byte but at voxels whose probability lies within
# SP_PROB_ABS of the threshold, and the probabilities within SP_PROB_ABS
SP_PREDICT = ("training.eval_batch_size=2", "training.compute_dtype=float32", "tta=tent",
              "evaluation.flip_tta.enable=true", "evaluation.flip_tta.axes=[1]", "predict.save_prob=true")
SP_PREDICT_ENV = {"NVIDIA_TF32_OVERRIDE": "0"}
SP_PROB_ABS = 1e-5


def sp_torchrun_cli(manifest: str, root: str, timeout: float = 600.0) -> dict:
    """``cli.train``, ``cli.adapt`` (Tent) and ``cli.predict``
    (``SP_PREDICT``) over two ranks on card 0 with ``training.mesh.space=2``
    under ``torch.distributed.run --nproc_per_node=2`` (gloo, as the CLI
    chooses for ranks that share a card) on phase 14's fixture: 1 epoch,
    then Tent and the export from its best checkpoint into
    ``root/export_space``; then ``cli.predict`` in one process from the
    same checkpoint into ``root/export_one`` (a command line as well, so
    both exports run with the same backend settings), for
    ``sp_predict_check``."""
    out = {}
    space = ["training.devices=[0,0]", "training.mesh.data=1", "training.mesh.space=2"]
    best = f"training.resume={os.path.join(root, 'train', 'checkpoints', 'best_model')}"
    for call, extra in (("train", ["training.epochs=1"]), ("adapt", ["tta=tent", "tta.report_no_adapt=true", best]),
                        ("predict", [*SP_PREDICT, best, f"predict.out_dir={root}/export_space"]),
                        ("predict_one", [*SP_PREDICT, best, f"predict.out_dir={root}/export_one"])):
        run_dir = os.path.join(root, call)
        if call == "predict_one":
            cmd = [sys.executable, "-m", "multimodal_tta_tpu_torch.cli.predict", *cli_overrides(manifest, run_dir,
                                                                                                 *extra)]
        else:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={SP_WORLD}",
                   "-m", f"multimodal_tta_tpu_torch.cli.{call}", *cli_overrides(manifest, run_dir, *space, *extra)]
        t0 = time.perf_counter()
        proc = run_command(cmd, timeout, SP_PREDICT_ENV if call.startswith("predict") else None)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli.{call} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        log_path = os.path.join(run_dir, f"{call.split('_')[0]}.log")
        text = proc.stdout + proc.stderr + (open(log_path, encoding="utf-8").read() if os.path.exists(log_path) else "")
        mesh = r"\{'data': 1, 'space': 1\} over 1 rank" if call == "predict_one" else \
            r"\{'data': 1, 'space': 2\} over 2 rank"
        mesh_lines = re.findall(r"Device mesh: " + mesh + r"\(s\)", text)
        if not mesh_lines or not os.path.exists(log_path):
            raise AssertionError(f"torchrun cli.{call}: mesh lines {mesh_lines} or no log file:\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        r = {"wall_s": wall}
        if call == "train":
            r["checkpoints"] = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            if "best_model.msgpack" not in r["checkpoints"]:
                raise AssertionError(f"torchrun cli.train wrote {r['checkpoints']}")
        elif call == "adapt":
            metrics = json.load(open(os.path.join(run_dir, "tta_metrics.json"), encoding="utf-8"))
            r["metrics"] = {k: metrics["adapted"][k] for k in ("gtvt_dc", "avg_hd95", "loss")
                            if k in metrics["adapted"]}
            if not all(math.isfinite(v) for v in r["metrics"].values()) or "no_adapt" not in metrics:
                raise AssertionError(f"torchrun cli.adapt metrics {metrics}")
        out[call] = r
    return out


def same_predictions(got: str, want: str, cases: int) -> dict:
    """Two exports' directories: the same file names, ``predictions.csv``
    and masks byte for byte (the NIfTI bytes; the gzip header holds a time
    stamp)."""
    import gzip

    names = sorted(os.listdir(want))
    r = {"cases": cases, "names_equal": sorted(os.listdir(got)) == names,
         "csv_equal": open(f"{got}/predictions.csv", "rb").read() == open(f"{want}/predictions.csv", "rb").read(),
         "masks_apart": []}
    for n in (n for n in names if n.endswith("_pred.nii.gz")):
        with gzip.open(f"{got}/{n}") as fa, gzip.open(f"{want}/{n}") as fb:
            a, b = fa.read(), fb.read()
        if a != b:
            apart = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))  # bytes apart: a mask holds a byte a voxel
            r["masks_apart"].append((n, apart))
    r["ok"] = bool(r["cases"] and r["names_equal"] and r["csv_equal"] and not r["masks_apart"])
    return r


def sp_predict_check(root: str, torchrun: dict) -> dict:
    """The space ranks' export (``root/export_space``) against one
    process's from the same checkpoint (``root/export_one``), both written
    by ``sp_torchrun_cli``: the file names, the masks byte for byte
    (``same_predictions``) but at voxels whose probability (one process's)
    lies within ``SP_PROB_ABS`` of the threshold, the probabilities within
    ``SP_PROB_ABS``, the manifest's rows equal but for the voxel counts of
    those voxels."""
    import csv

    import numpy as np

    from multimodal_tta_tpu_torch.data import nifti

    out = dict(torchrun)
    got, want = f"{root}/export_space", f"{root}/export_one"
    rows = [list(csv.DictReader(open(f"{d}/predictions.csv", encoding="utf-8"))) for d in (got, want)]
    r = same_predictions(got, want, len(rows[1]))
    r.update(prob_max_abs=0.0, apart_voxels=0, apart_from_threshold=0.0, voxels=0)
    counts_apart = []
    for row in rows[1]:
        case = row["case_id"]
        ma, mb = (nifti.load(f"{d}/{case}_pred.nii.gz").dataobj for d in (got, want))
        pa, pb = (np.asarray(nifti.load(f"{d}/{case}_prob.nii.gz").dataobj, np.float64) for d in (got, want))
        apart = ma != mb
        counts_apart.append(int(ma.astype(np.int64).sum() - mb.astype(np.int64).sum()))
        r["prob_max_abs"] = max(r["prob_max_abs"], float(np.abs(pa - pb).max()))
        r["apart_voxels"] += int(apart.sum())
        r["voxels"] += int(apart.size)
        if apart.any():
            r["apart_from_threshold"] = max(r["apart_from_threshold"], float(np.abs(pb[apart] - THRESHOLD).max()))
    count_keys = [k for k in rows[1][0] if k.startswith("voxels_")] if rows[1] else []
    same_rows = len(rows[0]) == len(rows[1]) and all(
        {k: v for k, v in a.items() if k not in count_keys} == {k: v for k, v in b.items() if k not in count_keys}
        and sum(int(a[k]) - int(b[k]) for k in count_keys) == d for a, b, d in zip(*rows, counts_apart))
    r["rows_equal_but_counts"] = same_rows
    r["ok"] = bool(r["cases"] and r["names_equal"] and same_rows and r["prob_max_abs"] <= SP_PROB_ABS
                   and r["apart_from_threshold"] <= SP_PROB_ABS
                   and r["apart_voxels"] <= (1.0 - SP_PRED_AGREE) * max(r["voxels"], 1))
    out["predict_compare"] = r
    if not r["ok"]:
        raise AssertionError(f"cli.predict over two space ranks against one process: {out['predict_compare']}")
    return out


def sp_expected(res: dict, cuda: bool) -> dict:
    """Each part's launches, derived from the model's split and whole norms
    (``res['norms']``; the mid-fusion UNet's ``res['mid']['norms']``, all
    split, remat recomputing each forward once): a forward launches the
    one-launch kernel for each whole norm and stats + apply for each split
    one; a training backward bwd_sums + bwd_apply for each split norm; a
    Tent backward no bwd_apply for the first norm (its input carries no
    gradient: the convolutions are frozen)."""
    s, w = (res["norms"]["split"], res["norms"]["whole"]) if cuda else (0, 0)
    mid = res["mid"]["norms"] if cuda else 0

    def launches(fwd=0, bwd=0, tent_bwd=0, minplus=0, mid_fwd=0, mid_bwd=0):
        return {"forward": w * fwd, "backward": w * (bwd + tent_bwd), "minplus": minplus * int(cuda),
                "plain_backward": 0, "instance_norm_stats": s * fwd + mid * mid_fwd,
                "instance_norm_apply": s * fwd + mid * mid_fwd, "instance_norm_bwd_sums": s * (bwd + tent_bwd) + mid * mid_bwd,
                "instance_norm_bwd_apply": s * bwd + (s - 1) * tent_bwd * int(cuda) + mid * mid_bwd}

    steps = len(res["losses"])
    return {"train": launches(fwd=steps + 1, bwd=steps, minplus=1),
            "tent_inline": launches(fwd=SP_TENT_BATCHES, tent_bwd=SP_TENT_BATCHES),
            "tent_post": launches(fwd=2 * SP_TENT_BATCHES, tent_bwd=SP_TENT_BATCHES),
            "evaluate": launches(fwd=2 * len(SP_EVAL_SIZES), tent_bwd=len(SP_EVAL_SIZES), minplus=len(SP_EVAL_SIZES)),
            "mid_train": launches(mid_fwd=2, mid_bwd=1)}


def space_parallel_phase(device, root: str, **kw) -> dict:
    """Phase 23: two ranks sharing the device over gloo on a ``data=1 x
    space=2`` mesh, spawned here, against the one-process run here on the
    same global batches: each rank's launches exactly, its split kernels
    against their plain versions, its peak memory against one process's.
    Its command lines under torchrun are ``sp_torchrun_cli``; ``main``
    spawns its ranks with phases 22 and 24's (``spawn_pairs``)."""
    prep = space_parallel_prepare(device, root, **kw)
    spawn_pairs([prep])
    return space_parallel_finish(prep)


def space_parallel_prepare(device, root: str, *, shape=SHAPE[:3], channels=(32, 64, 128, 256, 512),
                           mid_shape=BRATS_SHAPE, mid_channels=(32, 64, 128, 256, 512), init_filters: int = 16,
                           threads: int = 4) -> dict:
    """Phase 23 up to its ranks: the data, the teacher, the ranks' spec."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    out = {"backend": "gloo"}
    log(f"[space_parallel] two ranks on {device} over gloo, data=1 x space=2")
    spec = {"shape": list(shape), "channels": list(channels), "mid_channels": list(mid_channels),
            "init_filters": init_filters, "threads": threads, "data": os.path.join(root, "data.pt"),
            "teacher": sm_teacher(os.path.join(root, "teacher"), channels)}
    torch.save(sp_data(shape, mid_shape), spec["data"])
    spec["ranks_root"] = os.path.join(root, "ranks")
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "space_parallel", "device": device, "root": root, "t0": t0, "cuda": cuda, "out": out,
            "backend": "gloo", "spec": spec, "shape": shape}


def space_parallel_finish(prep: dict) -> dict:
    """Phase 23 after its ranks: the one-process run and the checks."""
    import shutil

    import torch

    device, root, t0, cuda, out, spec, shape = (prep[k] for k in ("device", "root", "t0", "cuda", "out", "spec",
                                                                  "shape"))
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(SP_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    t1 = time.perf_counter()
    threads_before = torch.get_num_threads()
    torch.set_num_threads(spec["threads"])
    try:
        one = sp_run(device, os.path.join(root, "one"), None, spec)
    finally:
        torch.set_num_threads(threads_before)
    out["one_s"] = time.perf_counter() - t1
    failed = []  # every check is made before a failure raises
    try:
        out["compare"] = sp_compare(one, ranks)
    except AssertionError as e:
        failed.append(str(e))
    try:
        out["models_compare"] = sm_compare(one["models"], [res["models"] for res in ranks])
    except AssertionError as e:
        failed.append(str(e))
    for res in ranks:
        want = sp_expected(res, cuda)
        for part, w in want.items():
            if res["launches"][part] != w:
                failed.append(f"{res['tag']} {part}: launches {res['launches'][part]}, derived {w}")
        for name, parts in sm_expected(res["models"], cuda).items():
            for part, w in parts.items():
                if res["models"][name]["launches"][part] != w:
                    failed.append(f"{res['tag']} {name} {part}: launches {res['models'][name]['launches'][part]}, "
                                  f"derived {w}")
        if res["store_shape"][1] != shape[0] // SP_WORLD:
            failed.append(f"{res['tag']}: the store holds {res['store_shape']}, not a slab")
        kc = res["kernel_check"]
        if not kc["split_ok"] or (cuda and not (kc["edt_bitwise"] and all(kc["edt_bitwise"]))):
            failed.append(f"{res['tag']} split kernels vs plain: {kc}")
    if cuda and not all(res["norms"]["split"] > 0 and res["norms"]["whole"] > 0 for res in ranks):
        failed.append(f"the flagship's levels {[r['norms'] for r in ranks]}")
    keys = ("forward", "backward", "minplus") + SPLIT_ENTRIES
    out["launches"] = {k: sum(res["launches"][p][k] for res in ranks for p in res["launches"]) for k in keys}
    out["models_launches"] = {k: sum(r["launches"][p][k] for res in ranks for r in res["models"].values()
                                     for p in r["launches"]) for k in keys}
    light = ("norms", "teacher_norms", "launches", "losses", "f32_ms", "bf16_ms", "peak_gib", "bf16_peak_gib", "moe")
    for res in ranks + [one]:
        res["models"] = {name: {k: v for k, v in r.items() if k in light} for name, r in res["models"].items()}
    out["ranks"] = [{k: res.get(k) for k in ("tag", "device", "launches", "kernel_check", "peak_gib",
                                             "mid_peak_gib", "losses", "norms", "store_shape", "part_s", "timing",
                                             "collectives_per_train_step", "collectives_per_tent_step", "models")}
                    for res in ranks]
    out["one"] = {k: one.get(k) for k in ("launches", "peak_gib", "mid_peak_gib", "losses", "norms", "timing",
                                          "part_s", "models")}
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("phase 23: " + " | ".join(failed) + f"; peaks: {[r['peak_gib'] for r in out['ranks']]}"
                             f" vs {out['one']['peak_gib']}, mid {[r['mid_peak_gib'] for r in out['ranks']]} vs "
                             f"{out['one']['mid_peak_gib']}; s {out['phase_s']:.1f}")
    return out


def log_space_parallel(sp: dict, card: str) -> None:
    """Phase 23's numbers, a line each."""
    import statistics

    def warm(ms):
        return statistics.median(ms[1:]) if len(ms) > 1 else float("nan")

    log_space_flagship(sp, card, warm)
    log_space_models(sp, card)
    if "torchrun" in sp:
        log(f"[space_parallel] torchrun --nproc_per_node=2 training.mesh.space=2: {sp['torchrun']}; card {card}")
    log(f"[space_parallel] phase 23 took {sp['phase_s']:.1f} s; launches over both ranks {sp['launches']}; "
        f"card {card}")


def log_space_flagship(sp: dict, card: str, warm) -> None:
    """Phase 23's flagship and mid-fusion numbers, a line each."""
    c, one = sp["compare"], sp["one"]
    log(f"[space_parallel] two ranks (data 1 x space 2) vs one process on the same global batches (f32, TF32 "
        f"off): losses {c['losses']['ranks']} vs {c['losses']['one']} (max rel {c['losses']['max_rel']:.3g}, "
        f"limit {SP_LOSS_REL}); the first step's gradients summed over the ranks {c['grads']} (limit "
        f"{SP_GRAD_REL}); validation metrics max abs {c['val_max_abs']:.3g}, TTAEngine.evaluate "
        f"{c['eval_max_abs']:.3g}; Tent {c['tent']}; the mid-fusion step {c['mid']} (limits: loss {SP_LOSS_REL}, "
        f"gradients {SP_MID_GRAD_REL}); ranks {sp['ranks_s']:.1f} s, "
        f"one process {sp['one_s']:.1f} s; card {card}")
    ot = one.get("timing") or {}
    for r in sp["ranks"]:
        t = r.get("timing") or {}
        kc = r["kernel_check"]
        log(f"[space_parallel] {r['tag']} on {r['device']}: norms {r['norms']} (split, whole); launches "
            f"{r['launches']}; split entries vs plain at every call of the f32 path (calls, max abs error, worst "
            f"share of the limit, elements at the kink) {kc['split']} and of the first bf16 training and Tent "
            f"steps {kc.get('split_bf16')}, ok {kc['split_ok']}; EDT bitwise {kc['edt_bitwise']}; the store "
            f"{r['store_shape']}; peak allocated {r['peak_gib']} GiB (flagship f32 main path) vs one process "
            f"{one['peak_gib']} GiB, mid-fusion f32 step {r['mid_peak_gib']} GiB vs {one['mid_peak_gib']} GiB, bf16 "
            f"runs {t.get('peak_gib')} vs {ot.get('peak_gib')} GiB; ms per bf16 training step (global 8, half "
            f"depth) {[round(v, 2) for v in t.get('train_step_ms', [])]} -> warm median "
            f"{warm(t.get('train_step_ms', [])):.2f} vs one process {warm(ot.get('train_step_ms', [])):.2f}; ms per "
            f"bf16 Tent step (global 2) {[round(v, 2) for v in t.get('tent_step_ms', [])]} -> "
            f"{warm(t.get('tent_step_ms', [])):.2f} vs one process {warm(ot.get('tent_step_ms', [])):.2f}; "
            f"collectives a bf16 training step (calls, bytes this rank sends) {r['collectives_per_train_step']}, a "
            f"Tent step {r['collectives_per_tent_step']}; s by part {r['part_s']} (one process {one['part_s']}); "
            f"card {card}")


def log_space_models(sp: dict, card: str) -> None:
    """Phase 23's other models, norms and training options, a line each."""
    one = sp["one"]
    for r in sp["ranks"]:
        kc = r["kernel_check"]
        log(f"[space_models] {r['tag']}: split entries vs plain at every call of the f32 path {kc['split']}, ok "
            f"{kc['split_ok']}; EDT bitwise {kc['edt_bitwise']}; card {card}")
    for name, c in sp["models_compare"].items():
        one_m = one["models"][name]
        log(f"[space_models] {name}: two ranks vs one process (f32, TF32 off): {c} (limits: losses "
            f"{SP_LOSS_REL}, gradients {SM_GRAD_REL.get(name, SP_GRAD_REL)}, Tent moves {SP_DELTA_REL}); card {card}")
        for r in sp["ranks"]:
            m = r["models"][name]
            log(f"[space_models] {name} {r['tag']}: norms {m['norms']} (split, whole), teacher "
                f"{m.get('teacher_norms')}; launches {m['launches']}; peak allocated {m['peak_gib']} GiB (f32 path) "
                f"vs one process {one_m['peak_gib']}, bf16 {m.get('bf16_peak_gib')} vs {one_m.get('bf16_peak_gib')}; "
                f"ms per f32 step {[round(v, 1) for v in m['f32_ms']]} vs one process "
                f"{[round(v, 1) for v in one_m['f32_ms']]}; ms per bf16 step (cold, warm) "
                f"{[round(v, 1) for v in m.get('bf16_ms', [])]} vs one process "
                f"{[round(v, 1) for v in one_m.get('bf16_ms', [])]}; card {card}")
    log(f"[space_models] launches over both ranks {sp['models_launches']}; card {card}")


SPLIT_REPLACES = {"instance_norm_stats": ":114", "instance_norm_apply": ":136", "instance_norm_bwd_sums": ":87",
                  "instance_norm_bwd_apply": ":87"}  # the TPU kernel's stats and normalize pallas_calls; its gradient


def split_summaries(sp: dict, card: str, sa: dict, st: dict, sx: dict, sc: dict) -> list:
    """The kernels line's entries of the four split-depth norm entries:
    launches on phase 23's main paths (both ranks; ``sa`` its adapters,
    windows, flip TTA and sliding window; ``st`` its transformers) and
    phase 27b's (``sx``: four ranks), phase 23's classifiers (``sc``: none
    ran, asserted), the largest error at the paths' own
    calls and at the timing table's inputs (f32 and bf16), times of one
    flagship training forward's split norm calls at batch 8 on one of two
    space ranks in f32 (and, under ``bf16``, in bf16)."""
    table = sp["table"]
    out = []
    for name in SPLIT_ENTRIES:
        e, e16, key = table["entries"][name], table["bf16"][name], SPLIT_KEYS[name]
        path_err = max([c["max_abs_err"] for r in sp["ranks"] for part in ("split", "split_bf16")
                        for k, c in r["kernel_check"].get(part, {}).items() if k.split()[0] == key]
                       + [c["max_abs_err"] for r in sa["ranks"] + st["ranks"] + sx["ranks"]
                          for k, c in r["check"]["split"].items() if k.split()[0] == key], default=0.0)
        out.append({
            "name": name, "route": "cuda", "source": "multimodal_tta_tpu_torch/csrc/fused_instance_norm.cu",
            "replaces": "multimodal_tta_tpu/pallas/fused_instance_norm.py" + SPLIT_REPLACES[name],
            "launches": sp["launches"][name] + sp["models_launches"][name] + sa["launches"][name]
            + st["launches"][name] + sx["launches"][name] + sc["launches"][name],
            "launches_by_path": {"space_parallel": sp["launches"][name], "space_models": sp["models_launches"][name],
                                 "space_adapters": sa["launches"][name], "space_transformers": st["launches"][name],
                                 "space_axes": sx["launches"][name], "space_classifiers": sc["launches"][name]},
            "max_abs_err": max(e["max_abs_err"], e16["max_abs_err"], path_err), "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"], "library_ms": None,
            "bf16": {k: e16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
            "per": f"the {table['calls']} split norm calls of one flagship training forward at global batch "
                   f"{TRAIN_BATCH}, one of {SP_WORLD} space ranks (f32 [8, D/2, H, W, C])",
            "card": card})
    return out


# ---- phase 23, evaluation and adaptation over a split depth ---------------------
# the same two ranks on card 0 (gloo) on data=1 x space=2, the flagship at
# full width (f32, TF32 off) on one HECKTOR21 batch of BATCH (phase 23's
# first two training volumes), against one process on the same batch:
# TTAEngine.evaluate with pl, eata (its Fisher batch), sar, cotta and memo
# (2 views each), episodic; Tent with windows (configs/tta/tent.yaml's roi
# and count); evaluation with flip TTA on axes 1, 2, 3 and with the sliding
# window (seg_eval's default roi: the depth padded to 64, nine windows,
# each split). Each case runs once with every split-entry call (SplitCheck)
# and every whole-norm and min-plus call (CallCheck) held to its plain
# version, the launches counted and the predictions gathered, then once
# unchecked for its ms, its peak above the memory live at its start and the
# bytes it gathers and reduces; limits: phase 23's
SA_WORLD = 2
SA_METHODS = ("pl", "eata", "sar", "cotta", "memo")
SA_CASES = SA_METHODS + ("tent_windows", "flip_tta", "sliding_window")
SA_TIMEOUT_S = 600
SA_KNOBS = {
    "pl": {"pl": {"conf_threshold": 0.6}},
    "eata": {"reliability": {"margin_ratio": 1.0}, "fisher": {"batches": 1}},
    "sar": {"margin_ratio": 1.0},
    "cotta": {"n_views": 2},
    "memo": {"n_views": 2},
}
SA_WINDOW_ROI = (32, 96, 96)  # configs/tta/tent.yaml: tta.window
SA_WINDOWS = 4
SA_SLIDING_ROI = (64, 64, 64)  # evaluation.sliding_window's default
SA_OVERLAP = 0.25
# the forwards and backwards of one evaluated batch: the adaptation step
# (EATA's Fisher batch adds a forward and a backward at the source), then
# the scoring forward; flip TTA's 2^3 mirrored forwards; the sliding
# window's windows (``sa_passes``)
SA_PASSES = {"pl": (2, 1), "eata": (3, 2), "sar": (3, 2), "cotta": (4, 1), "memo": (5, 2), "tent_windows": (2, 1),
             "flip_tta": (8, 0)}
# pl's objective has hard edges (the pseudo-label at p = 0.5, the
# confidence gate), so the voxels that rounding moves across them move its
# step: its adapted tensors are held to twice one process's own distance
# when only the norms' sums are reordered (the witness: the same step with
# the plain norm) where that is above SP_DELTA_REL
SA_WITNESSED = ("pl",)


def sa_config(case: str, window_roi=SA_WINDOW_ROI, sliding_roi=SA_SLIDING_ROI) -> dict:
    """The evaluation config of one case (episodic adaptation)."""
    if case in SA_METHODS:
        cfg = eval_config(case, True)
        cfg["tta"].update(json.loads(json.dumps(SA_KNOBS[case])))
    elif case == "tent_windows":
        cfg = eval_config("tent", True)
        cfg["tta"]["window"] = {"enabled": True, "roi_size": list(window_roi), "windows_per_step": SA_WINDOWS}
    else:
        cfg = eval_config("none", True)
        if case == "flip_tta":
            cfg["evaluation"]["flip_tta"] = {"enable": True, "axes": [1, 2, 3]}
        else:
            cfg["evaluation"]["sliding_window"] = {"enable": True, "roi_size": list(sliding_roi),
                                                   "overlap": SA_OVERLAP}
    return cfg


def sa_passes(case: str, shape, sliding_roi=SA_SLIDING_ROI) -> tuple:
    """(forwards, backwards) of one evaluated batch of ``case``."""
    if case != "sliding_window":
        return SA_PASSES[case]
    from multimodal_tta_tpu_torch.ops.sliding_window import window_starts

    return math.prod(len(window_starts(max(n, r), r, SA_OVERLAP)) for n, r in zip(shape, sliding_roi)), 0


def record_adapter(engine, rec: dict) -> None:
    """After each adapted batch of ``engine``: the step's entropies, the
    adapted tensors (by name, in the adapter's order) and CoTTA's teacher,
    into ``rec`` (``evaluate`` restores the source after its last batch)."""
    adapter, make = engine.adapter, engine.adapter.make_adapt_fn

    def make_adapt_fn(source):
        fn = make(source)

        def adapt_fn(state, *args, **kwargs):
            state = fn(state, *args, **kwargs)
            params = dict(state.named_parameters())
            rec["ents"].append(adapter._last_ents.detach().cpu().clone())
            rec["adapted"].append({n: params[n].detach().cpu().clone() for n in adapter._names})
            rec["teacher"].append([t.detach().cpu().clone() for t in getattr(adapter, "_teacher", [])])
            return state

        return adapt_fn

    adapter.make_adapt_fn = make_adapt_fn


def sa_run(device, mesh, spec: dict) -> dict:
    """The slice's phase-23 cases in this process: over the ranks of
    ``mesh`` (data 1 x space 2), or in one process (``mesh`` None) on the
    same global batch. Per case: the metrics, entropies, adapted tensors and
    gathered predictions, the norms that ran split and whole, the launches,
    every kernel call against its plain version; then unchecked its ms,
    peak and collective bytes."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.layers import set_plain_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    batch = torch.load(spec["data"], weights_only=False)
    channels = tuple(spec["channels"])
    model = UNet3D(in_channels=2, num_classes=1, channels=channels, strides=(2,) * (len(channels) - 1),
                   num_res_units=2, dtype=torch.float32, device=dev, seed=0)
    source = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    gather = (lambda t: t) if mesh is None else mesh.gather
    rank = mesh.rank if mesh is not None else 0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def engine_of(case: str, preds=None):
        cfg = sa_config(case, spec["window_roi"], spec["sliding_roi"])
        engine = TTAEngine(ConfigNode(cfg), device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
        if preds is not None:  # the scored masks, gathered whole
            probs_fn, thr = engine.strategy._probs_fn, engine.strategy.threshold

            def recording(state, with_variance=False, space=None):
                fn = probs_fn(state, with_variance, space)

                def probs(image):
                    out = fn(image)
                    preds.append(gather((out[1] >= thr).to(torch.uint8)).cpu())
                    return out

                return probs

            engine.strategy._probs_fn = recording
        return engine

    out = {"tag": f"rank{rank}" if mesh is not None else "one", "cases": {}}
    split, calls = SplitCheck(), CallCheck()
    calls.on = cuda

    def checked_backwards() -> int:  # the plain backward calls that CallCheck itself makes
        return sum(v["calls"] for k, v in calls.seen.items() if k.startswith("backward"))

    for case in SA_CASES:
        rec, preds = {"ents": [], "adapted": [], "teacher": []}, []
        engine = engine_of(case, preds)
        if engine.adapter is not None:
            record_adapter(engine, rec)
        at, checks = split_counts(), checked_backwards()
        with split, calls, NormLevels(model) as levels:
            metrics = engine.evaluate(model, [batch])
        sync()
        launches = {k: v - at[k] for k, v in split_counts().items()}
        launches["plain_backward"] -= checked_backwards() - checks
        r = {"metrics": metrics, "launches": launches, "norms": {"split": len(levels.split), "whole": len(levels.whole)},
             "preds": preds if rank == 0 else None, **rec}
        if mesh is None and case in SA_WITNESSED:  # one process again, its norms' sums in another order
            witness = {"ents": [], "adapted": [], "teacher": []}
            engine = engine_of(case)
            record_adapter(engine, witness)
            set_plain_norm(model, True)
            try:
                engine.evaluate(model, [batch])
            finally:
                set_plain_norm(model, False)
            r["witness"] = witness
        # unchecked: ms per evaluated batch, the peak above what is live, the collectives
        engine = engine_of(case)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            live = torch.cuda.memory_allocated(dev)
        with CollectiveBytes() as coll:
            sync()
            t0 = time.perf_counter()
            engine.evaluate(model, [batch])
            sync()
        r["ms"] = (time.perf_counter() - t0) * 1e3
        r["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - live) / 2**30 if cuda else None
        r["collectives"] = {"calls": dict(coll.calls), "bytes": dict(coll.bytes)}
        out["cases"][case] = r
    names = {n for r in out["cases"].values() for a in r["adapted"] for n in a}
    out["source"] = {n: v for n, v in source.items() if n in names}
    out["check"] = {"split": split.seen, "calls": calls.seen}
    out["check_ok"] = (mesh is None or split.ok()) and (
        not cuda or calls.ok(["forward float32", "backward float32", "minplus"]))
    return out


def sa_expected(res: dict, cuda: bool, shape, sliding_roi=SA_SLIDING_ROI) -> dict:
    """Each case's launches, derived from the norms that ran split and whole
    (``NormLevels``) and the case's forwards and backwards (``sa_passes``):
    a forward takes the one-launch kernel for each whole norm and stats +
    apply for each split one, a backward the backward kernel for each whole
    norm and bwd_sums + bwd_apply for each split one but the first (its
    input carries no gradient: the convolutions are frozen); one min-plus
    launch for the evaluated batch."""
    out = {}
    for case, r in res["cases"].items():
        s, w = (r["norms"]["split"], r["norms"]["whole"]) if cuda else (0, 0)
        f, b = sa_passes(case, shape, sliding_roi)
        out[case] = {"forward": w * f, "backward": w * b, "minplus": int(cuda), "plain_backward": 0,
                     "instance_norm_stats": s * f, "instance_norm_apply": s * f, "instance_norm_bwd_sums": s * b,
                     "instance_norm_bwd_apply": max(s - 1, 0) * b}
    return out


def sa_compare(one: dict, ranks: list) -> dict:
    """The two ranks' cases against one process's: metrics, entropies,
    adapted tensors (and CoTTA's teacher), predictions; each rank alike.
    Every check is made before a failure raises."""
    r0 = ranks[0]
    out, failed = {"ranks": len(ranks), "cases": {}}, []
    for case, o in one["cases"].items():
        a = r0["cases"][case]
        c = {}
        floats = [k for k, v in o["metrics"].items() if isinstance(v, float)]
        c["metrics_max_abs"] = max(abs(a["metrics"][k] - o["metrics"][k]) for k in floats)
        if set(a["metrics"]) != set(o["metrics"]) or any(
                abs(a["metrics"][k] - o["metrics"][k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(o["metrics"][k])
                for k in floats):
            failed.append(f"{case}: metrics {a['metrics']} vs {o['metrics']}")
        if any(res["cases"][case]["metrics"] != a["metrics"] for res in ranks):
            failed.append(f"{case}: the ranks' metrics differ")
        states = ad_states(a, o, one["source"]) if o["ents"] else {"ents_max_rel": 0.0, "delta_rel_l2": 0.0,
                                                                   "teacher_rel_l2": 0.0}
        c.update(states)
        c["delta_limit"] = SP_DELTA_REL
        if "witness" in o:
            c["witness_rel_l2"] = ad_states(o["witness"], o, one["source"])["delta_rel_l2"]
            c["delta_limit"] = max(SP_DELTA_REL, 2.0 * c["witness_rel_l2"])
        if states["ents_max_rel"] > SP_LOSS_REL or max(states["delta_rel_l2"], states["teacher_rel_l2"]) > c["delta_limit"]:
            failed.append(f"{case}: against one process {states} (limit {c['delta_limit']})")
        if not all(ad_ranks_equal(res["cases"][case], a) for res in ranks[1:]):
            failed.append(f"{case}: the ranks' entropies, adapted tensors or teacher differ")
        c["pred_agree"] = min(float((p == q).float().mean()) for p, q in zip(a["preds"], o["preds"]))
        if len(a["preds"]) != len(o["preds"]) or c["pred_agree"] < SP_PRED_AGREE:
            failed.append(f"{case}: predictions agree on {c['pred_agree']}")
        c["dice"] = o["metrics"].get("gtvt_dc")
        out["cases"][case] = c
    if failed:
        raise AssertionError("phase 23 (adapters over space), two ranks vs one process: " + "; ".join(failed)
                             + f"; all: {out}")
    return out


def _sa_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """The slice's phase-23 cases, rank side, in an initialised process
    group: a ``data=1 x space=2`` mesh, ``sa_run``."""
    from multimodal_tta_tpu_torch.parallel.mesh import make_mesh

    return sa_run(device, make_mesh([_rank_device(device)] * world, data=1, space=world), spec)


def space_adapters_phase(device, root: str, **kw) -> dict:
    """The slice's phase-23 cases alone: two ranks sharing the device over
    gloo on a ``data=1 x space=2`` mesh, spawned here, against the
    one-process run here (``main`` spawns their ranks with phases 22-24's,
    ``spawn_pairs``)."""
    prep = space_adapters_prepare(device, root, **kw)
    spawn_pairs([prep])
    return space_adapters_finish(prep)


def space_adapters_prepare(device, root: str, *, shape=SHAPE[:3], channels=(32, 64, 128, 256, 512),
                           window_roi=SA_WINDOW_ROI, sliding_roi=SA_SLIDING_ROI, threads: int = 4) -> dict:
    """Up to the ranks: the batch (phase 23's first two training volumes)
    and the ranks' spec."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    spec = {"shape": list(shape), "channels": list(channels), "window_roi": list(window_roi),
            "sliding_roi": list(sliding_roi), "threads": threads, "data": os.path.join(root, "data.pt"),
            "ranks_root": os.path.join(root, "ranks")}
    torch.save(_stack(hecktor_volumes(BATCH, SP_TRAIN_SEED, shape)), spec["data"])
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "space_adapters", "device": device, "root": root, "t0": t0,
            "cuda": torch.device(device).type == "cuda", "out": {"backend": "gloo"}, "backend": "gloo",
            "spec": spec}


def space_adapters_finish(prep: dict) -> dict:
    """After the ranks: the one-process run and the checks (each rank's
    launches against ``sa_expected``, its kernels against their plain
    versions, ``sa_compare``)."""
    import shutil

    import torch

    device, root, t0, cuda, out, spec = (prep[k] for k in ("device", "root", "t0", "cuda", "out", "spec"))
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(SA_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    t1 = time.perf_counter()
    held = torch.get_num_threads()
    torch.set_num_threads(spec["threads"])
    try:
        one = sa_run(device, None, spec)
    finally:
        torch.set_num_threads(held)
    out["one_s"] = time.perf_counter() - t1
    failed = []
    try:
        out["compare"] = sa_compare(one, ranks)
    except AssertionError as e:
        failed.append(str(e))
    for res in ranks:
        for case, want in sa_expected(res, cuda, spec["shape"], spec["sliding_roi"]).items():
            if res["cases"][case]["launches"] != want:
                failed.append(f"{res['tag']} {case}: launches {res['cases'][case]['launches']}, derived {want}")
        if not res["check_ok"]:
            failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    if cuda and not one["check_ok"]:
        failed.append(f"one process kernels vs plain: {one['check']}")
    keys = ("forward", "backward", "minplus") + SPLIT_ENTRIES
    out["launches"] = {k: sum(r["launches"][k] for res in ranks for r in res["cases"].values()) for k in keys}
    light = ("launches", "norms", "ms", "peak_gib", "collectives")
    out["cases"] = list(SA_CASES)
    out["ranks"] = [{"tag": res["tag"], "check": res["check"], "s": res["s"],
                     "launches": {c: r["launches"] for c, r in res["cases"].items()},
                     "cases": {c: {k: r[k] for k in light} for c, r in res["cases"].items()}} for res in ranks]
    out["one"] = {"check": one["check"], "cases": {c: {k: r[k] for k in light} for c, r in one["cases"].items()}}
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("phase 23 (adapters over space): " + " | ".join(failed))
    return out


def log_space_adapters(sa: dict, card: str) -> None:
    """The slice's phase-23 numbers, a line each case."""
    log(f"[space_adapters] two ranks (data 1 x space 2, gloo) vs one process, the flagship at full width on one "
        f"batch of {BATCH}, f32 (TF32 off): ranks {sa['ranks_s']:.1f} s, one process {sa['one_s']:.1f} s; card "
        f"{card}")
    for case, c in sa["compare"]["cases"].items():
        one = sa["one"]["cases"][case]
        per_rank = [(r["cases"][case]["ms"], r["cases"][case]["peak_gib"], r["cases"][case]["collectives"])
                    for r in sa["ranks"]]
        log(f"[space_adapters]   {case}: metrics within {c['metrics_max_abs']:.3g} of one process (limit "
            f"{DP_METRIC_ABS} + {DP_METRIC_REL} x |v|), entropies {c['ents_max_rel']:.3g} (limit {SP_LOSS_REL}), "
            f"adapted tensors {c['delta_rel_l2']:.3g} of one process's moves (limit {c['delta_limit']:.3g}"
            + (f"; one process's own with the plain norm {c['witness_rel_l2']:.3g}" if "witness_rel_l2" in c else "")
            + f"), predictions "
            f"equal on {c['pred_agree']:.6f} of voxels (limit {SP_PRED_AGREE}), Dice {c['dice']}; norms "
            f"{sa['ranks'][0]['cases'][case]['norms']} (split, whole), launches a rank "
            f"{sa['ranks'][0]['launches'][case]}; per rank (ms per evaluated batch, peak GiB above the live memory, "
            f"collectives: calls and bytes this rank sends) {per_rank} vs one process {one['ms']:.1f} ms, "
            f"{one['peak_gib']} GiB; card {card}")
    for r in sa["ranks"] + [dict(sa["one"], tag="one")]:
        log(f"[space_adapters]   {r['tag']}: kernels vs plain {json.dumps(r['check'])}")
    log(f"[space_adapters] took {sa['phase_s']:.1f} s; launches over both ranks {sa['launches']}; card {card}")


# ---- phase 23, UNETR and SwinUNETR over a split depth; the sequence axis --------
# the same two ranks on card 0 (gloo) on data=1 x space=2, f32 (TF32 off),
# against one process on the same global batches: UNETR and SwinUNETR at
# configs/model/'s widths on one HECKTOR21 batch of BATCH (phase 23's first
# two training volumes): a forward (the logits gathered), one SGD step of the
# recipe's criterion, a continual Tent step, one evaluated batch with the
# surface metrics; UNETR with seq_shard_axis=space on one BraTS volume (4
# channels, 3 classes: 1200 tokens, 600 a rank; every level from 160 planes
# down to the 10-plane grid split): a forward and one SGD step. Every split
# norm call (SplitCheck) and every whole-norm and min-plus call (CallCheck)
# held to its plain version as the path makes it; each rank's launches
# derived from the norms that ran split and whole (NormLevels); the first
# step's summed gradients within SP_GRAD_REL of one process's
ST_WORLD = 2
ST_CASES = ("unetr", "swin_unetr", "unetr_seq")
ST_SEED = 280
ST_BRATS_SEED = 281
ST_TIMEOUT_S = 600
ST_LOGIT_REL = 1e-4  # the gathered logits' relative L2 against one process's (phase 25's TP_LOGIT_REL)
ST_FIRST_NORMS = 1  # norms whose input needs no gradient in a Tent step: the first one on the raw input


def st_specs(spec: dict) -> dict:
    """Each case: its model node (``configs/model/``, ``spec``'s overrides),
    image size, criterion (None: the recipe's), device transform, data key,
    and whether it takes a Tent step and an evaluated batch."""
    unetr = model_node("unetr", **spec.get("unetr", {}))
    swin = model_node("swin_unetr", **spec.get("swin", {}))
    hecktor = dict(image_size=list(spec["shape"]), criterion=None, transform=DEVICE_TRANSFORM, data="hecktor",
                   adapt=True)
    return {"unetr": dict(hecktor, model=unetr), "swin_unetr": dict(hecktor, model=swin),
            "unetr_seq": dict(model=dict(unetr, in_channels=4, num_classes=3, seq_shard_axis="space"),
                              image_size=list(spec["brats_shape"]), criterion=MID_CRITERION,
                              transform={"normalize": False}, data="brats", adapt=False)}


def st_run(device, mesh, spec: dict) -> dict:
    """The transformers' cases (``ST_CASES``) in this process: over the
    ranks of ``mesh`` (data 1 x space 2), or in one process (``mesh`` None)
    on the same global batches. Per case: the gathered logits, the loss and
    the first step's gradients (summed over the ranks; rank 0 keeps them),
    Tent's entropies, moves and gathered predictions, the evaluated
    metrics, the norms that ran split and whole, each part's launches."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.ops.intensity import make_intensity_normalizer
    from multimodal_tta_tpu_torch.parallel import space as sp
    from multimodal_tta_tpu_torch.registry import get_model
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    data = torch.load(spec["data"], weights_only=False)
    local = (lambda t: t) if mesh is None else mesh.local
    gather = (lambda t: t) if mesh is None else mesh.gather
    rank = mesh.rank if mesh is not None else 0
    ax = sp.axis_of(mesh)
    recipe = train_recipe(os.path.join(spec["ranks_root"], "recipe"))["training"]["criterion"]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    split, calls = SplitCheck(), CallCheck()
    calls.on = cuda

    def mark() -> dict:
        """The launch counters and the plain backward calls CallCheck itself made."""
        return dict(split_counts(), checked=calls.backward_calls())

    def since(at: dict) -> dict:
        sync()
        now = mark()
        out = {k: v - at[k] for k, v in now.items() if k != "checked"}
        out["plain_backward"] -= now["checked"] - at["checked"]
        return out

    def build(case: dict):
        cfg = ConfigNode(sm_config(case["model"], case["criterion"] or recipe, "float32",
                                   data={"transforms": {"image_size": case["image_size"]}}))
        model = get_model(case["model"]["name"]).from_config(cfg.model, dtype=torch.float32, remat=False,
                                                             image_size=case["image_size"], device=dev,
                                                             seed=ST_SEED)
        optimizer, lr = build_optimizer(cfg.training, model, mesh)
        trainer = SegTrainer(cfg, device_transform=case["transform"], device=dev, mesh=mesh)
        trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
        return model, trainer

    def step(trainer, batch) -> tuple:
        """One ``run_step``: the loss and the gradients it applied (summed
        over the ranks), flat in sorted name order, on the CPU."""
        grads, apply = {}, trainer.state.apply_gradients

        def first():
            names = sorted(n for n, p in trainer.state.model.named_parameters() if p.grad is not None)
            params = dict(trainer.state.model.named_parameters())
            grads["flat"] = torch.cat([params[n].grad.detach().flatten() for n in names]).cpu()
            grads["names"] = [(n, params[n].numel()) for n in names]
            trainer.state.apply_gradients = apply
            return apply()

        trainer.state.apply_gradients = first
        trainer.run_step({"image": batch["image"], "label": batch["label"]})
        return trainer.flush_step_metrics()["loss"], grads

    specs = st_specs(spec)
    out = {"tag": f"rank{rank}" if mesh is not None else "one", "cases": {}}
    for name in spec.get("cases", ST_CASES):
        case = specs[name]
        batch = data[case["data"]]
        norm_fn = make_intensity_normalizer(normalize=case["transform"].get("normalize", False),
                                            intensity_policy=case["transform"].get("intensity_policy"),
                                            channel_names=case["transform"].get("channel_names"))
        model, trainer = build(case)
        r = {"launches": {}}
        with split, calls, NormLevels(model) as levels:
            at = mark()
            with torch.no_grad(), sp.sharded(mesh):
                x = norm_fn(torch.from_numpy(local(batch["image"])).to(dev), space=ax)
                logits = gather(model(x))
            r["launches"]["forward"] = since(at)
            r["logits"] = logits.cpu() if rank == 0 else None
            r["logits_sq"] = float(logits.double().square().sum())
            del logits, x
            at = mark()
            r["loss"], grads = step(trainer, batch)
            r["launches"]["train"] = since(at)
            r["grads"] = grads if rank == 0 else None
            r["grads_sq"] = float(grads["flat"].double().square().sum())
            if case["adapt"]:
                tcfg = ConfigNode(eval_config("tent", False))
                ad = TentAdapter(tcfg.tta, config=tcfg, device_transform=case["transform"], device=dev, mesh=mesh)
                fn = ad.make_adapt_predict_fn(model, THRESHOLD, "inline")
                norm = {n for n, k in norm_param_mask(model).items() if k}
                before = {n: p.detach().clone() for n, p in model.named_parameters() if n in norm}
                at = mark()
                _, pred = fn(model, torch.from_numpy(local(batch["image"])), batch["image"].shape[0])
                r["launches"]["tent"] = since(at)
                pred = gather(pred).cpu()  # every rank gathers
                r["tent"] = {"ents": ad._last_ents.cpu().tolist(),
                             "moved": {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()
                                       if n in norm},
                             "preds": pred if rank == 0 else None}
                ad.restore()
                engine = TTAEngine(ConfigNode(eval_config("none", False)), device_transform=case["transform"],
                                   device=dev, mesh=mesh)
                at = mark()
                r["eval"] = engine.evaluate(model, [batch])
                r["launches"]["evaluate"] = since(at)
        r["norms"] = {"split": len(levels.split), "whole": len(levels.whole)}
        del model, trainer
        if cuda:
            torch.cuda.empty_cache()
        out["cases"][name] = r
    out["check"] = {"split": split.seen, "calls": calls.seen}
    out["check_ok"] = (mesh is None or split.ok()) and (
        not cuda or calls.ok(["forward float32", "backward float32", "minplus"]))
    return out


def st_expected(res: dict, cuda: bool) -> dict:
    """Each case's launches by part, derived from the norms that ran split
    and whole (``NormLevels``): a forward takes the one-launch kernel for
    each whole norm and stats + apply for each split one; the training
    backward the backward kernel for each whole norm and bwd_sums +
    bwd_apply for each split one; Tent's backward no bwd_apply for the first
    norm (its input carries no gradient: the convolutions are frozen); one
    min-plus launch for the evaluated batch."""
    out = {}
    for name, r in res["cases"].items():
        s, w = (r["norms"]["split"], r["norms"]["whole"]) if cuda else (0, 0)

        def launches(fwd=0, bwd=0, tent_bwd=0, minplus=0):
            return {"forward": w * fwd, "backward": w * (bwd + tent_bwd), "minplus": minplus * int(cuda),
                    "plain_backward": 0, "instance_norm_stats": s * fwd, "instance_norm_apply": s * fwd,
                    "instance_norm_bwd_sums": s * (bwd + tent_bwd),
                    "instance_norm_bwd_apply": s * bwd + max(s - ST_FIRST_NORMS, 0) * tent_bwd}

        want = {"forward": launches(fwd=1), "train": launches(fwd=1, bwd=1)}
        if "tent" in r:
            want["tent"] = launches(fwd=1, tent_bwd=1)
            want["evaluate"] = launches(fwd=1, minplus=1)
        out[name] = want
    return out


def _flat_rel(a: dict, b: dict) -> float:
    """Relative L2 of two flat gradients (``st_run``'s) of the same names."""
    if a["names"] != b["names"]:
        return float("inf")
    return float((a["flat"] - b["flat"]).norm() / b["flat"].norm())


def st_compare(one: dict, ranks: list) -> dict:
    """The two ranks' cases against one process's: logits, loss, the first
    step's gradients (within SP_GRAD_REL), Tent's entropies, moves and
    predictions, metrics; each rank alike. Every check is made before a
    failure raises."""
    import torch

    r0 = ranks[0]
    out, failed = {"ranks": len(ranks), "cases": {}}, []
    for name, o in one["cases"].items():
        a = r0["cases"][name]
        c = {"logits_rel_l2": float((a["logits"] - o["logits"]).norm() / o["logits"].norm()),
             "loss": [a["loss"], o["loss"]], "loss_rel": abs(a["loss"] - o["loss"]) / abs(o["loss"]),
             "grad_rel_l2": _flat_rel(a["grads"], o["grads"])}
        if c["logits_rel_l2"] > ST_LOGIT_REL or c["loss_rel"] > SP_LOSS_REL or c["grad_rel_l2"] > SP_GRAD_REL:
            failed.append(f"{name}: {c}")
        if any(res["cases"][name][k] != a[k] for res in ranks for k in ("loss", "logits_sq", "grads_sq")):
            failed.append(f"{name}: the ranks' losses, logits or gradients differ")
        if "tent" in o:
            t, ot = a["tent"], o["tent"]
            keys = sorted(ot["moved"])
            diff = torch.cat([(t["moved"][k] - ot["moved"][k]).flatten() for k in keys])
            ref = torch.cat([ot["moved"][k].flatten() for k in keys])
            c["tent"] = {"ents_max_rel": max(abs(x - y) / abs(y) for x, y in zip(t["ents"], ot["ents"])),
                         "delta_rel_l2": float(diff.norm() / ref.norm()),
                         "pred_agree": float((t["preds"] == ot["preds"]).float().mean())}
            if c["tent"]["ents_max_rel"] > SP_LOSS_REL or c["tent"]["delta_rel_l2"] > SP_DELTA_REL \
                    or c["tent"]["pred_agree"] < SP_PRED_AGREE:
                failed.append(f"{name} Tent: {c['tent']}")
            if any(res["cases"][name]["tent"]["ents"] != t["ents"] for res in ranks):
                failed.append(f"{name} Tent: the ranks' entropies differ")
            e0, oe = a["eval"], o["eval"]
            floats = [k for k, v in oe.items() if isinstance(v, float)]
            c["eval_max_abs"] = max(abs(e0[k] - oe[k]) for k in floats)
            c["dice"] = oe.get("gtvt_dc")
            if set(e0) != set(oe) or any(abs(e0[k] - oe[k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(oe[k])
                                         for k in floats) or any(res["cases"][name]["eval"] != e0 for res in ranks):
                failed.append(f"{name} evaluation: {e0} vs {oe}")
        out["cases"][name] = c
    if failed:
        raise AssertionError("phase 23 (transformers over space), two ranks vs one process: " + "; ".join(failed)
                             + f"; all: {out}")
    return out


def _st_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """The transformers' phase-23 cases, rank side, in an initialised
    process group: a ``data=1 x space=2`` mesh, ``st_run``."""
    from multimodal_tta_tpu_torch.parallel.mesh import make_mesh

    return st_run(device, make_mesh([_rank_device(device)] * world, data=1, space=world), spec)


def space_transformers_phase(device, root: str, **kw) -> dict:
    """The transformers' phase-23 cases alone: two ranks sharing the device
    over gloo, spawned here, against the one-process run here (``main``
    spawns their ranks with phases 22-24's, ``spawn_pairs``)."""
    prep = space_transformers_prepare(device, root, **kw)
    spawn_pairs([prep])
    return space_transformers_finish(prep)


def space_transformers_prepare(device, root: str, *, shape=SHAPE[:3], brats_shape=BRATS_SHAPE, unetr=None,
                               swin=None, cases=ST_CASES, threads: int = 4) -> dict:
    """Up to the ranks: the batches (phase 23's first two training volumes;
    one BraTS volume from a seed) and the ranks' spec; ``unetr`` / ``swin``
    override the configs' widths (the CPU tests' fixture size)."""
    import shutil

    import torch

    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    spec = {"shape": list(shape), "brats_shape": list(brats_shape), "unetr": dict(unetr or {}),
            "swin": dict(swin or {}), "cases": list(cases), "threads": threads,
            "data": os.path.join(root, "data.pt"), "ranks_root": os.path.join(root, "ranks")}
    torch.save({"hecktor": _stack(hecktor_volumes(BATCH, SP_TRAIN_SEED, tuple(shape))),
                "brats": _stack(brats_volumes(1, tuple(brats_shape), seed=ST_BRATS_SEED))}, spec["data"])
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "space_transformers", "device": device, "root": root, "t0": t0,
            "cuda": torch.device(device).type == "cuda", "out": {"backend": "gloo"}, "backend": "gloo",
            "spec": spec}


def space_transformers_finish(prep: dict) -> dict:
    """After the ranks: the one-process run and the checks (each rank's
    launches against ``st_expected``, its kernels against their plain
    versions, ``st_compare``)."""
    import shutil

    import torch

    device, root, t0, cuda, out, spec = (prep[k] for k in ("device", "root", "t0", "cuda", "out", "spec"))
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(ST_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    t1 = time.perf_counter()
    held = torch.get_num_threads()
    torch.set_num_threads(spec["threads"])
    try:
        one = st_run(device, None, spec)
    finally:
        torch.set_num_threads(held)
    out["one_s"] = time.perf_counter() - t1
    failed = []
    try:
        out["compare"] = st_compare(one, ranks)
    except AssertionError as e:
        failed.append(str(e))
    for res in ranks + [one]:
        for case, want in st_expected(res, cuda).items():
            if res["cases"][case]["launches"] != want:
                failed.append(f"{res['tag']} {case}: launches {res['cases'][case]['launches']}, derived {want}")
        if not res["check_ok"]:
            failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    keys = ("forward", "backward", "minplus") + SPLIT_ENTRIES
    out["launches"] = {k: sum(p[k] for res in ranks for r in res["cases"].values() for p in r["launches"].values())
                       for k in keys}
    out["cases"] = list(spec["cases"])
    out["ranks"] = [{"tag": res["tag"], "check": res["check"], "s": res["s"],
                     "norms": {c: r["norms"] for c, r in res["cases"].items()},
                     "launches": {c: r["launches"] for c, r in res["cases"].items()}} for res in ranks]
    out["one"] = {"check": one["check"], "norms": {c: r["norms"] for c, r in one["cases"].items()}}
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("phase 23 (transformers over space): " + " | ".join(failed))
    return out


def log_space_transformers(st: dict, card: str) -> None:
    """The transformers' phase-23 numbers, a line each case."""
    log(f"[space_transformers] two ranks (data 1 x space 2, gloo) vs one process, f32 (TF32 off): UNETR and "
        f"SwinUNETR at configs/model/'s widths on one HECKTOR21 batch of {BATCH}, UNETR with seq_shard_axis=space "
        f"on one BraTS volume: ranks {st['ranks_s']:.1f} s, one process {st['one_s']:.1f} s; card {card}")
    for case, c in st["compare"]["cases"].items():
        log(f"[space_transformers]   {case}: logits {c['logits_rel_l2']:.3g} rel L2 of one process's (limit "
            f"{ST_LOGIT_REL}); loss {c['loss']} ({c['loss_rel']:.3g}, limit {SP_LOSS_REL}); first step's gradients "
            f"{c['grad_rel_l2']:.3g} (limit {SP_GRAD_REL})" + (f"; Tent {json.dumps(c['tent'])}; metrics within {c['eval_max_abs']:.3g}"
                                            f", Dice {c['dice']}" if "tent" in c else "")
            + f"; norms a rank {st['ranks'][0]['norms'][case]} (one process {st['one']['norms'][case]}); launches "
            f"a rank {st['ranks'][0]['launches'][case]}; card {card}")
    for r in st["ranks"] + [dict(st["one"], tag="one")]:
        log(f"[space_transformers]   {r['tag']}: kernels vs plain {json.dumps(r['check'])}")
    log(f"[space_transformers] took {st['phase_s']:.1f} s; launches over both ranks {st['launches']}; card {card}")


# ---- phase 23, the CNN classifiers over a split image height -----------------
# the same two ranks on card 0 (gloo) on data=1 x space=2 against one process
# on the same global batches, f32 with TF32 off: ResNet-50 in Tent's setting
# ([CLS_BATCH, CLS_SIDE, CLS_SIDE, 3], CLS_CLASSES classes) through
# classifier_logits_apply: an inference forward, a continual Tent step, and
# one step each of pl, eata, sar, cotta (2 views), memo (2 views) and norm;
# DenseNet-121, EfficientNet-B0 and EfficientNet-V2-S at CLS_FAMILY_BATCH: a
# forward and a Tent step. Each rank holds its rows of the images' height
# (Mesh.local); a level runs on the rank's slab while the height rule holds
# (parallel/space.py:row_axes), whole from the first op that breaks it.
# Gates, fixed: logits within SC_LOGIT_REL relative L2 of one process's, the
# adapted affines' moves within SP_GRAD_REL, the running statistics within
# SC_STATS_REL (sc_stats_rel: a variance of its tensor's largest value, a
# mean of its BatchNorm's largest running standard deviation, since
# EfficientNet's expand convs give batch means of ~1e-9 whose rounding is
# their values' scale), the predictions equal. In f32 the moves are rounding
# at this init: BN -> ReLU -> conv -> BN makes the entropy nearly invariant
# to an earlier BN's scale, so its gradient cancels (phase 18's
# CLS_PARITY_DELTA_REL_L2), and two summation orders move it by ~1e-2 (the
# CPU fixture of the job: 1.6e-2). So the f32 pass at Tent's setting gates
# the logits and reports the rest, and the same cases computed in f64 (the
# compute dtype, the BatchNorms' affines and statistics too) at
# CLS_FAMILY_BATCH carry every gate. No norm or min-plus kernel on this
# path: 0 launches a rank, asserted. Then a timing pass: ResNet-50's bf16
# Tent step, ms a step and peak memory a rank against one process, and the
# space group's collective calls and bytes a step.
SC_WORLD = 2
SC_SEED = 290
SC_TIMEOUT_S = 600
SC_LOGIT_REL = 1e-5
SC_STATS_REL = 1e-5
SC_METHODS = ("tent", "pl", "eata", "sar", "cotta", "memo", "norm")
SC_FAMILIES = ("densenet121", "efficientnet_b0", "efficientnet_v2_s")
SC_KNOBS = {"pl": {"pl": {"conf_threshold": 0.2}},
            "eata": {"reliability": {"margin_ratio": 1.0}, "fisher": {"batches": 1, "lambda": 50.0}},
            "sar": {"lr": 0.2, "rho": 0.5, "margin_ratio": 1.0},
            "cotta": {"ema": 0.9, "n_views": 2}, "memo": {"n_views": 2, "serve": "marginal"}}
SC_TIMED_STEPS = 5


def sc_config(method: str) -> dict:
    """A classifier adapter's config: softmax entropy, one continual step
    at lr 0.1 (``SC_KNOBS``' overrides), f32."""
    tta = {"method": method, "steps": 1, "lr": 0.1, "optimizer": "sgd", "momentum": 0.9, "update": "norm",
           "episodic": False, **SC_KNOBS.get(method, {})}
    return {"task": {"seed": 0}, "training": {"criterion": {"softmax": True, "sigmoid": False},
                                              "compute_dtype": "float32"}, "tta": tta}


def sc_images(n: int, side: int, seed: int):
    import numpy as np

    return (np.random.RandomState(seed).randn(n, side, side, 3) * 1.5 + 0.3).astype(np.float32)


class CollectiveCount:
    """Counts the calls of ``torch.distributed``'s ``all_reduce`` and
    ``all_gather`` made inside the block, and the bytes of the tensors
    handed to them (an all-gather's input, an all-reduce's tensor)."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.bytes, self._held = 0, 0, (dist.all_reduce, dist.all_gather)
        reduce, gather = self._held

        def all_reduce(t, *a, **k):
            self.calls, self.bytes = self.calls + 1, self.bytes + t.numel() * t.element_size()
            return reduce(t, *a, **k)

        def all_gather(parts, t, *a, **k):
            self.calls, self.bytes = self.calls + 1, self.bytes + t.numel() * t.element_size()
            return gather(parts, t, *a, **k)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.all_gather = self._held
        return False


def sc_run(device, mesh, spec: dict) -> dict:
    """The classifiers' cases in this process: over the ranks of ``mesh``
    (data 1 x space 2), or in one process (``mesh`` None) on the same global
    batches. Per case: the logits (rank 0 keeps them), each method's
    entropies, the adapted affines' moves, the running statistics and the
    predictions; the kernels' launches; the bf16 timing pass."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.layers import BatchNorm, running_statistics
    from multimodal_tta_tpu_torch.parallel import space as sp
    from multimodal_tta_tpu_torch.registry import get_model, get_tta_method
    from multimodal_tta_tpu_torch.tta import classifier_logits_apply, norm_param_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    local = (lambda t: t) if mesh is None else mesh.local
    rows = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    rank = mesh.rank if mesh is not None else 0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def build(name: str, batch: int, dtype=torch.float32):
        m = get_model(name).from_config(ConfigNode({"num_classes": spec["classes"]}), dtype=dtype, device=dev,
                                        seed=SC_SEED)
        if dtype == torch.float64:  # the adapted affines and the statistics held in f64 too
            for bn in m.modules():
                if isinstance(bn, BatchNorm):
                    bn.double()
        return classifier_logits_apply(m), torch.from_numpy(local(sc_images(batch, spec["side"], SC_SEED + 1))).to(dev)

    def snapshot(model, names) -> dict:
        params = dict(model.named_parameters())
        return {"affines": {n: params[n].detach().float().cpu().clone() for n in names},
                "stats": {k: v.float().cpu() for k, v in running_statistics(model).items()}}

    def split_levels(model, x) -> int:
        """How many BatchNorm calls of an inference forward ran on a slab."""
        seen = []
        hooks = [m.register_forward_pre_hook(lambda mod, a: seen.append(a[0].shape[2]))
                 for m in model.modules() if isinstance(m, BatchNorm)]
        with torch.no_grad(), sp.sharded(mesh):
            model(x)
        for h in hooks:
            h.remove()
        return seen

    def adapt(model, x, method: str, n: int) -> dict:
        cfg = ConfigNode(sc_config(method))
        ad = get_tta_method(method)(cfg.tta, config=cfg, device=dev, mesh=mesh)
        names = sorted(n for n, k in norm_param_mask(model).items() if k)
        before = snapshot(model, names)
        if method == "norm":
            ad.make_adapt_fn(model)(model, x, n)
            ents, pred = [], None
        else:
            fn = ad.make_adapt_predict_fn(model, threshold=0.5, predict_mode="post")
            _, pred = fn(model, x, n)
            ents, pred = ad._last_ents.float().cpu().tolist(), rows(pred).cpu()
        sync()
        after = snapshot(model, names)
        ad.restore()
        moves = {n: after["affines"][n] - before["affines"][n] for n in names}
        return {"ents": ents, "moves": moves, "stats": after["stats"], "preds": pred}

    out = {"tag": f"rank{rank}" if mesh is not None else "one", "passes": {}}
    at = split_counts()
    for tag, pass_spec in spec["passes"].items():
        batches, dtype = pass_spec["batches"], getattr(torch, pass_spec["dtype"])
        cases = out["passes"][tag] = {}
        for name in ("resnet50",) + tuple(spec["families"]):
            model, x = build(name, batches[name], dtype)
            r = {}
            with torch.no_grad(), sp.sharded(mesh):
                logits = rows(model(x)).float()
            sync()
            r["logits"] = logits.cpu() if rank == 0 else None
            r["slabs"] = split_levels(model, x)
            for method in (SC_METHODS if name == "resnet50" else ("tent",)):
                r[method] = adapt(model, x, method, batches[name])
            cases[name] = r
            del model, x, logits
            if cuda:
                torch.cuda.empty_cache()
    sync()
    now = split_counts()
    out["launches"] = {k: now[k] - at[k] for k in now}

    # the timing pass: ResNet-50's continual bf16 Tent step (inline predictions)
    n = spec["passes"]["f32"]["batches"]["resnet50"]
    model, x = build("resnet50", n, torch.bfloat16)
    cfg = ConfigNode(dict(sc_config("tent"), training={"criterion": {"softmax": True, "sigmoid": False},
                                                       "compute_dtype": "bfloat16"}))
    ad = get_tta_method("tent")(cfg.tta, config=cfg, device=dev, mesh=mesh)
    fn = ad.make_adapt_predict_fn(model, threshold=0.5, predict_mode="inline")
    fn(model, x, n)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    with CollectiveCount() as coll:
        for _ in range(spec["timed_steps"]):
            t0 = time.perf_counter()
            fn(model, x, n)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    out["timing"] = {"ms": sorted(times)[len(times) // 2], "all_ms": times,
                     "peak_gib": (torch.cuda.max_memory_allocated(dev) if cuda else 0) / 2**30,
                     "collective_calls": coll.calls / spec["timed_steps"],
                     "collective_mb": coll.bytes / spec["timed_steps"] / 2**20}
    ad.restore()
    del model, x
    if cuda:
        torch.cuda.empty_cache()
    return out


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else float((a - b).norm())


def sc_stats_rel(got: dict, want: dict) -> float:
    """The running statistics' largest distance: a variance against its
    tensor's largest value, a mean against the largest running standard
    deviation of its BatchNorm (a mean near 0 is rounding of the batch's
    sum at the scale of its values, not of itself)."""
    out = 0.0
    for k, v in want.items():
        base = want[k[:-len("mean")] + "var"].max().sqrt() if k.endswith(".mean") else v.abs().max()
        out = max(out, float((got[k] - v).abs().max() / base))
    return out


def sc_compare(one: dict, ranks: list) -> dict:
    """The two ranks' cases against one process's, pass by pass: the
    logits, and for each method the entropies, the moves of the adapted
    affines, the running statistics and the predictions. The f64 pass
    carries every gate, the f32 pass the logits' (its moves and what follows
    from them are reported). Every check is made before a failure raises."""
    import torch

    r0 = ranks[0]
    out, failed = {"ranks": len(ranks), "passes": {}}, []
    for tag, cases in one["passes"].items():
        gated = tag == "f64"
        out["passes"][tag] = {}
        for name, o in cases.items():
            a = r0["passes"][tag][name]
            c = {"logits_rel_l2": _rel_l2(a["logits"], o["logits"]),
                 "levels": {"split": sum(s < w for s, w in zip(a["slabs"], o["slabs"])),
                            "whole": sum(s == w for s, w in zip(a["slabs"], o["slabs"]))}}
            if c["logits_rel_l2"] > SC_LOGIT_REL:
                failed.append(f"{tag} {name} forward: logits {c['logits_rel_l2']:.3g} (limit {SC_LOGIT_REL})")
            if len(a["slabs"]) != len(o["slabs"]) or not c["levels"]["split"] or not all(
                    s * SC_WORLD == w or s == w for s, w in zip(a["slabs"], o["slabs"])):
                failed.append(f"{tag} {name}: BatchNorm rows {a['slabs']} against one process's {o['slabs']}")
            for method in (m for m in SC_METHODS if m in o):
                t, ot = a[method], o[method]
                keys = sorted(ot["moves"])
                got = torch.cat([t["moves"][k].flatten() for k in keys])
                moved = torch.cat([ot["moves"][k].flatten() for k in keys])
                m = {"moves_rel_l2": _rel_l2(got, moved) if float(moved.norm()) > 0 else float(got.abs().max()),
                     "stats_rel": sc_stats_rel(t["stats"], ot["stats"]),
                     "ents_max_rel": max([abs(x - y) / abs(y) if y else abs(x) for x, y in zip(t["ents"], ot["ents"])],
                                         default=0.0),
                     "preds_equal": ot["preds"] is None or bool(torch.equal(t["preds"], ot["preds"]))}
                if gated and (m["moves_rel_l2"] > SP_GRAD_REL or m["stats_rel"] > SC_STATS_REL
                              or m["ents_max_rel"] > SP_LOSS_REL or not m["preds_equal"]):
                    failed.append(f"{tag} {name} {method}: {m}")
                c[method] = m
            out["passes"][tag][name] = c
    if failed:
        raise AssertionError("phase 23 (classifiers over space), two ranks vs one process: " + "; ".join(failed)
                             + f"; all: {out}")
    return out


def _sc_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """The classifiers' phase-23 cases, rank side, in an initialised process
    group: a ``data=1 x space=2`` mesh, ``sc_run``."""
    from multimodal_tta_tpu_torch.parallel.mesh import make_mesh

    return sc_run(device, make_mesh([_rank_device(device)] * world, data=1, space=world), spec)


def space_classifiers_phase(device, root: str, **kw) -> dict:
    """The classifiers' phase-23 cases alone: two ranks sharing the device
    over gloo, spawned here, against the one-process run here (``main``
    spawns their ranks with phases 22-24's, ``spawn_pairs``)."""
    prep = space_classifiers_prepare(device, root, **kw)
    spawn_pairs([prep])
    return space_classifiers_finish(prep)


def space_classifiers_prepare(device, root: str, *, side: int = CLS_SIDE, batch: int = CLS_BATCH,
                              family_batch: int = CLS_FAMILY_BATCH, classes: int = CLS_CLASSES,
                              families=SC_FAMILIES, timed_steps: int = SC_TIMED_STEPS, threads: int = 4) -> dict:
    """Up to the ranks: the ranks' spec (each process makes the images from
    ``SC_SEED``): the f64 pass at ``family_batch``, the f32 pass with
    ResNet-50 at ``batch`` and the other families at ``family_batch``."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    every = {f: family_batch for f in families}
    spec = {"side": side, "classes": classes, "families": list(families), "timed_steps": timed_steps,
            "passes": {"f64": {"dtype": "float64", "batches": {"resnet50": family_batch, **every}},
                       "f32": {"dtype": "float32", "batches": {"resnet50": batch, **every}}},
            "threads": threads, "ranks_root": os.path.join(root, "ranks")}
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "space_classifiers", "device": device, "root": root, "t0": time.perf_counter(),
            "cuda": torch.device(device).type == "cuda", "out": {"backend": "gloo"}, "backend": "gloo",
            "spec": spec}


def space_classifiers_finish(prep: dict) -> dict:
    """After the ranks: the one-process run and the checks (``sc_compare``;
    no kernel launched on either side)."""
    import shutil

    import torch

    device, root, t0, out, spec = (prep[k] for k in ("device", "root", "t0", "out", "spec"))
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(SC_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    t1 = time.perf_counter()
    held = torch.get_num_threads()
    torch.set_num_threads(spec["threads"])
    try:
        one = sc_run(device, None, spec)
    finally:
        torch.set_num_threads(held)
    out["one_s"] = time.perf_counter() - t1
    failed = []
    try:
        out["compare"] = sc_compare(one, ranks)
    except AssertionError as e:
        failed.append(str(e))
    for res in ranks + [one]:
        if any(res["launches"].values()):
            failed.append(f"{res['tag']}: kernel launches {res['launches']} on the classifiers' path (0 expected)")
    out["launches"] = {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]}
    out["timing"] = {"ranks": [res["timing"] for res in ranks], "one": one["timing"],
                     "batch": spec["passes"]["f32"]["batches"]["resnet50"], "side": spec["side"]}
    out["batches"] = {tag: p["batches"] for tag, p in spec["passes"].items()}
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("phase 23 (classifiers over space): " + " | ".join(failed))
    return out


def log_space_classifiers(sc: dict, card: str) -> None:
    """The classifiers' phase-23 numbers: a line a family a pass, the timing pass."""
    t = sc["timing"]
    log(f"[space_classifiers] two ranks (data 1 x space 2, gloo) vs one process, TF32 off: ResNet-50 (forward; "
        f"tent, pl, eata, sar, cotta, memo, norm) and {', '.join(n for n in sc['batches']['f32'] if n != 'resnet50')} "
        f"(forward, tent) at {t['side']} px, batches {sc['batches']}: ranks {sc['ranks_s']:.1f} s, one process "
        f"{sc['one_s']:.1f} s; card {card}")
    for tag, cases in sc["compare"]["passes"].items():
        for name, c in cases.items():
            log(f"[space_classifiers]   {tag} {name}: logits {c['logits_rel_l2']:.3g} rel L2 (limit {SC_LOGIT_REL}); "
                f"BatchNorm calls on a slab {c['levels']['split']}, whole {c['levels']['whole']}; "
                + "; ".join(f"{m} moves {c[m]['moves_rel_l2']:.3g}, stats {c[m]['stats_rel']:.3g}, entropies "
                            f"{c[m]['ents_max_rel']:.3g}, predictions equal {c[m]['preds_equal']}"
                            for m in SC_METHODS if m in c)
                + (f" (limits: moves {SP_GRAD_REL}, stats {SC_STATS_REL}, entropies {SP_LOSS_REL})" if tag == "f64"
                   else " (reported)") + f"; card {card}")
    r = t["ranks"][0]
    log(f"[space_classifiers] timing, ResNet-50 bf16 continual Tent step at {t['batch']}x{t['side']}x{t['side']}: "
        f"{r['ms']:.1f} ms a step a rank (all ranks {[round(x['ms'], 1) for x in t['ranks']]}) vs {t['one']['ms']:.1f} "
        f"ms one process; peak {r['peak_gib']:.2f} GiB a rank vs {t['one']['peak_gib']:.2f} GiB; the space group's "
        f"collectives {r['collective_calls']:.0f} calls, {r['collective_mb']:.1f} MiB a step a rank; card {card}")
    log(f"[space_classifiers] took {sc['phase_s']:.1f} s; launches over both ranks {sc['launches']}; card {card}")

# ---- phase 24: every adapter over the data axis --------------------------------
# two ranks share the one card (gloo), as in phase 22; the flagship at full
# width on HECKTOR21 batches of BATCH; TTAEngine.evaluate with pl, eata, sar,
# cotta and memo, episodic and continual, each over AD_BATCHES batches, in f32
# against one process on the same global batches (phase 22's limits), every
# norm and min-plus call of that path held to its plain version as it runs
# (CallCheck); then each method's bf16 ms per evaluated batch, a rank against
# one process; then cli.adapt tta=sar and cli.predict under torchrun
AD_WORLD = 2
AD_METHODS = ("pl", "eata", "sar", "cotta", "memo")
AD_BATCHES = 2
AD_TIMED = 2  # bf16 batches timed per method (after one warm batch)
AD_SEED = 240
# each method's knobs beyond eval_config's: pl's threshold that some voxels
# clear; EATA's gate open to every sample and its Fisher on the first batch;
# SAR's filter open (and, episodic, a recovery floor at H_max, so every step
# resets: the reset driven open); CoTTA's teacher with restore; MEMO with 3
# views and restore
AD_KNOBS = {
    "pl": {"pl": {"conf_threshold": 0.6}},
    "eata": {"reliability": {"margin_ratio": 1.0}, "fisher": {"batches": 1}},
    "sar": {"margin_ratio": 1.0},
    "cotta": {"restore": {"enabled": True, "prob": 0.01}},
    "memo": {"n_views": 3, "restore": {"enabled": True, "prob": 0.01}},
}
AD_SAR_OPEN_FLOOR = 1.0
AD_TIMEOUT_S = 900
# norm launches of one flagship forward, and the forwards / backwards of one
# evaluated batch (one adaptation step, then the scoring forward) by method;
# EATA adds a forward and a backward at the source on its Fisher batch
AD_PER_FORWARD = 18
AD_PASSES = {"pl": (2, 1), "eata": (2, 1), "sar": (3, 2), "cotta": (4, 1), "memo": (7, 3)}


def ad_config(method: str, episodic: bool) -> dict:
    cfg = eval_config(method, episodic)
    cfg["tta"].update(json.loads(json.dumps(AD_KNOBS[method])))
    if method == "sar" and episodic:
        cfg["tta"]["reset_floor_ratio"] = AD_SAR_OPEN_FLOOR
    return cfg


def ad_expected(method: str, batches: int, cuda: bool) -> dict:
    """The kernel launches of ``TTAEngine.evaluate`` with ``method`` over
    ``batches`` batches, on each rank and in one process."""
    f, b = AD_PASSES[method]
    if method == "eata":
        f, b = f * batches + 1, b * batches + 1
    else:
        f, b = f * batches, b * batches
    n = AD_PER_FORWARD if cuda else 0
    return {"forward": n * f, "backward": n * b, "minplus": batches if cuda else 0}


class CallCheck:
    """While ``on``, every call that the path makes to the norm kernel's
    forward and backward operators and to the min-plus EDT is held against
    its plain version on the same arguments (the kernel's result goes on
    down the path): y within TOL_F32 / TOL_BF16 and the statistics within
    GRAD_F32_*; dx within phase 2's f32 limit / DX_BF16_REL off the ReLU's
    kink, dgamma and dbeta within GRAD_F32_* plus the kink's share; the EDT
    bitwise. The check launches no kernel. Per check and dtype: the calls,
    the max |error| and the worst share of its limit (<= 1 passes)."""

    def __init__(self):
        self.on, self.seen = True, {}

    def __enter__(self):
        import importlib

        self._fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
        self._edt = importlib.import_module("multimodal_tta_tpu_torch.kernels.edt_minplus")
        self._orig = [(self._fin, "_forward_op"), (self._fin, "_backward_op"), (self._edt, "_edt_op")]
        self._held = [getattr(m, n) for m, n in self._orig]
        for (m, n), op in zip(self._orig, self._held):
            setattr(m, n, self._wrap(op, n))
        return self

    def __exit__(self, *exc):
        for (m, n), op in zip(self._orig, self._held):
            setattr(m, n, op)
        return False

    def _note(self, key: str, err: float, worst: float) -> None:
        s = self.seen.setdefault(key, {"calls": 0, "max_abs_err": 0.0, "worst": float("-inf")})
        s["calls"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["worst"] = max(s["worst"], worst)

    def _wrap(self, op, name: str):
        def checked(*args):
            import torch

            got = op(*args)
            if self.on and args[0].device.type == "cuda":
                with torch.no_grad():
                    getattr(self, name.strip("_"))(args, got)
            return got

        return checked

    def forward_op(self, args, got) -> None:
        import torch

        x, gamma, beta, eps, relu = args
        y, stats = got
        y_p, mean, rstd = self._fin._plain_forward(x, gamma, beta, eps, relu)
        tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
        diff = (y.float() - y_p.float()).abs()
        worst = float(((diff - tol["rtol"] * y_p.float().abs()) / tol["atol"]).max())
        e2, w2 = _sums_check(stats, torch.stack((mean, rstd)))
        self._note(f"forward {str(x.dtype).replace('torch.', '')}", max(float(diff.max()), float(e2)),
                   max(worst, float(w2)))

    def backward_op(self, args, got) -> None:
        import torch

        gy, x, gamma, beta, stats, relu, need_dx = args
        dx, dgamma, dbeta = got
        want = self._fin.instance_norm_backward_plain(gy, x, gamma, beta, stats[0], stats[1], relu, need_dx)
        shp = (1,) * (x.dim() - 1) + (x.shape[-1],)
        b = x.shape[0]
        xhat = (x.float() - stats[0].view(b, *shp[1:])) * stats[1].view(b, *shp[1:])
        kink = (xhat * gamma + beta).abs() < KINK_MARGIN if relu else torch.zeros_like(xhat, dtype=torch.bool)
        a = gy.float().abs() * kink
        worst, err = float("-inf"), 0.0
        for got_s, want_s, slack in ((dgamma, want[1], (a * xhat.abs()).sum(dim=(0, 1, 2, 3))),
                                     (dbeta, want[2], a.sum(dim=(0, 1, 2, 3)))):
            e, w = _sums_check(got_s.float(), want_s.float(), slack)
            err, worst = max(err, float(e)), max(worst, float(w))
        if need_dx:
            ref = want[0].float()
            diff = torch.where(kink, 0.0, (dx.float() - ref).abs())
            vmax = float(ref.abs().max())
            if x.dtype == torch.bfloat16:
                w = float((diff - DX_BF16_REL * ref.abs()).max()) / (DX_BF16_REL * vmax)
            else:
                w = float(diff.max()) / (GRAD_F32_REL * vmax + GRAD_F32_ABS)
            err, worst = max(err, float(diff.max())), max(worst, w)
        self._note(f"backward {str(x.dtype).replace('torch.', '')}", err, worst)

    def edt_op(self, args, got) -> None:
        points, spacing, sqrt = args
        want = self._edt.squared_edt_volumes_plain(points, spacing, sqrt=sqrt)
        same = bool(((got == want) | (got.isinf() & want.isinf())).all())
        self._note("minplus", 0.0 if same else float("inf"), 0.0 if same else float("inf"))

    def ok(self, keys) -> bool:
        """Every check in ``keys`` seen, and every check within its limit."""
        return set(keys) <= set(self.seen) and all(s["worst"] <= 1.0 for s in self.seen.values())

    def backward_calls(self) -> int:
        """The plain backward calls the checks made (a path's own count of
        them is the counter's less these)."""
        return sum(v["calls"] for k, v in self.seen.items() if k.startswith("backward"))


def ad_data(shape, batches: int) -> list:
    """The phase's global host batches of BATCH (two domains)."""
    import numpy as np

    vols = hecktor_volumes(BATCH * batches, AD_SEED, shape)
    return [{"image": np.stack([v["image"] for v in vols[i * BATCH:(i + 1) * BATCH]]),
             "label": np.stack([v["label"] for v in vols[i * BATCH:(i + 1) * BATCH]]),
             "domain": [v["domain"] for v in vols[i * BATCH:(i + 1) * BATCH]]} for i in range(batches)]


def ad_run(device, mesh, spec: dict) -> dict:
    """Phase 24's main path in this process: over the ranks of ``mesh``, or
    in one process (``mesh`` None) on the same global batches."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    batches = torch.load(spec["data"], weights_only=False)
    mk = dict(in_channels=2, num_classes=1, channels=tuple(spec["channels"]), strides=(2,) * (len(spec["channels"]) - 1),
              num_res_units=2, device=dev, seed=0)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches}

    def engine_of(method: str, episodic: bool):
        return TTAEngine(ConfigNode(ad_config(method, episodic)), device_transform=DEVICE_TRANSFORM, device=dev,
                         mesh=mesh)

    out = {"tag": f"rank{mesh.rank}" if mesh is not None else "one", "runs": {}}
    if cuda:  # the peak is read above the memory live at the start (the smoke's earlier phases hold some)
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
    model = UNet3D(**mk, dtype=torch.float32)
    out["source"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    check = CallCheck()
    with check:
        check.on = cuda
        for method in AD_METHODS:
            for episodic in (True, False):
                engine = engine_of(method, episodic)
                copies = [0]
                copy_source = engine.adapter._copy_source

                def counted(copy_source=copy_source, copies=copies):
                    copies[0] += 1
                    copy_source()

                engine.adapter._copy_source = counted
                rec = {"ents": [], "adapted": [], "teacher": []}
                record_adapter(engine, rec)
                at, t0 = counts(), time.perf_counter()
                metrics = engine.evaluate(model, batches)
                sync()
                r = {"metrics": metrics, "s": time.perf_counter() - t0,
                     "launches": {k: v - at[k] for k, v in counts().items()}, **rec}
                if method == "sar":  # a recovery reset snaps back once; so do an episodic batch and restore()
                    r["resets"] = copies[0] - (len(batches) if episodic else 0) - 1
                out["runs"][f"{method}_{'episodic' if episodic else 'continual'}"] = r
        names = {n for r in out["runs"].values() for a in r["adapted"] for n in a}
        out["source"] = {n: v for n, v in out["source"].items() if n in names}
        # bf16: each method's ms per evaluated batch (continual): one cold
        # batch with every kernel call checked, then AD_TIMED unchecked
        del model
        model16 = UNet3D(**mk, dtype=torch.bfloat16)
        out["bf16_ms"] = {}
        for method in AD_METHODS:
            engine = engine_of(method, False)
            check.on = cuda
            engine.evaluate(model16, batches[:1])  # cold: the kernels' plans, cuDNN's choices
            sync()
            check.on = False
            t0 = time.perf_counter()
            engine.evaluate(model16, (batches * AD_TIMED)[:AD_TIMED])
            sync()
            out["bf16_ms"][method] = (time.perf_counter() - t0) * 1e3 / AD_TIMED
    out["check"] = check.seen
    out["check_ok"] = check.ok(["forward float32", "backward float32", "forward bfloat16", "backward bfloat16",
                                "minplus"]) if cuda else None
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - live) / 2**30 if cuda else 0.0
    return out


def ad_states(a: dict, b: dict, source: dict) -> dict:
    """Run ``a`` (a rank's) against run ``b`` (one process's) of the same
    method: the entropies' largest relative difference, and after each
    batch the adapted tensors' and CoTTA's teacher's distance, relative L2
    of one process's moves from ``source`` (0 where both sit at source)."""
    import torch

    def rel(xs, ys, src) -> float:
        if not xs:
            return 0.0
        d = float(torch.cat([(x - y).flatten() for x, y in zip(xs, ys)]).double().norm())
        m = float(torch.cat([(y - s).flatten() for y, s in zip(ys, src)]).double().norm())
        return 0.0 if d == 0 else (d / m if m > 0 else float("inf"))

    if [e.shape for e in a["ents"]] != [e.shape for e in b["ents"]] or len(a["adapted"]) != len(b["adapted"]):
        return {"ents_max_rel": float("inf"), "delta_rel_l2": float("inf"), "teacher_rel_l2": float("inf")}
    ea = torch.cat([e.flatten() for e in a["ents"]]).double()
    eb = torch.cat([e.flatten() for e in b["ents"]]).double()
    out = {"ents_max_rel": float(((ea - eb).abs() / eb.abs()).max()) if eb.numel() else 0.0,
           "delta_rel_l2": 0.0, "teacher_rel_l2": 0.0}
    for x, y, tx, ty in zip(a["adapted"], b["adapted"], a["teacher"], b["teacher"]):
        names = list(y)
        if list(x) != names or len(tx) != len(ty):
            return dict(out, delta_rel_l2=float("inf"))
        src = [source[n] for n in names]
        out["delta_rel_l2"] = max(out["delta_rel_l2"], rel([x[n] for n in names], [y[n] for n in names], src))
        out["teacher_rel_l2"] = max(out["teacher_rel_l2"], rel(tx, ty, src[:len(ty)]))
    return out


def ad_ranks_equal(a: dict, b: dict) -> bool:
    """Two ranks' runs: the entropies, the adapted tensors and the teacher
    after each batch equal bit for bit."""
    import torch

    def same(xs, ys):
        return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))

    return (same(a["ents"], b["ents"]) and len(a["adapted"]) == len(b["adapted"])
            and all(list(x) == list(y) and same(list(x.values()), list(y.values()))
                    for x, y in zip(a["adapted"], b["adapted"]))
            and all(same(x, y) for x, y in zip(a["teacher"], b["teacher"])) and len(a["teacher"]) == len(b["teacher"]))


def _rank_device(device: str):
    """Every rank's device: card 0 (or the card ``device`` names), or the CPU."""
    import torch

    d = torch.device(device)
    return torch.device("cuda", d.index or 0) if d.type == "cuda" else d


def _ad_job(rank: int, world: int, device: str, spec: dict) -> dict:
    """Phase 24's rank side in an initialised process group: a ``data=2``
    mesh, ``ad_run``."""
    from multimodal_tta_tpu_torch.parallel.mesh import make_mesh

    return ad_run(device, make_mesh([_rank_device(device)] * world, data=world), spec)


# phase -> (its rank side, its time limit): the two-rank phases that share a spawn
PAIR_JOBS = {"data_parallel": (_dp_job, DP_TIMEOUT_S), "space_parallel": (_sp_job, SP_TIMEOUT_S),
             "space_adapters": (_sa_job, SA_TIMEOUT_S), "space_transformers": (_st_job, ST_TIMEOUT_S),
             "space_classifiers": (_sc_job, SC_TIMEOUT_S), "adapters": (_ad_job, AD_TIMEOUT_S)}


def _pair_rank(rank: int, world: int, store: str, backend: str, device: str, jobs: list) -> None:
    """One rank of phases 22-24 (those of ``jobs``, in turn): the process
    group over a ``file://`` store in ``store``, then each job's rank side,
    its result (with its seconds) written to the job's ``ranks_root``."""
    import datetime

    sys.path.insert(0, REPO)
    import torch

    from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed(backend, f"file://{store}/store", world, rank, device=device,
                                 timeout=datetime.timedelta(seconds=sum(PAIR_JOBS[n][1] for n, _ in jobs)))
    for name, spec in jobs:
        torch.set_num_threads(spec.get("threads", 4))
        t0 = time.perf_counter()
        res = PAIR_JOBS[name][0](rank, world, device, spec)
        res["s"] = time.perf_counter() - t0
        torch.save(res, os.path.join(spec["ranks_root"], f"rank{rank}.pt"))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def spawn_pairs(preps: list) -> float:
    """The rank side of ``preps`` (``*_prepare`` results of phases 22-24)
    in two ranks spawned once, over the first one's backend (the ranks
    share the card: gloo); returns the seconds."""
    import shutil

    from multimodal_tta_tpu_torch.parallel.distributed import spawn_ranks

    store = os.path.join(preps[0]["root"], "pair_store")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store, exist_ok=True)
    jobs = [(p["name"], p["spec"]) for p in preps]
    t0 = time.perf_counter()
    spawn_ranks(_pair_rank, 2, store, (store, preps[0]["backend"], str(preps[0]["device"]), jobs),
                sum(PAIR_JOBS[n][1] for n, _ in jobs))
    return time.perf_counter() - t0


def ad_torchrun_cli(manifest: str, root: str, timeout: float = 600.0) -> dict:
    """``cli.adapt tta=sar`` under torchrun over two ranks, then
    ``cli.predict`` under torchrun over two ranks (one case a rank a batch)
    into ``root/ranks``, for ``ad_predict_check``. Two ranks share card 0
    (``training.devices=[0,0]``, gloo)."""
    out = {}
    ranks2 = ["training.devices=[0,0]"]
    for call, tag, extra in (("adapt", "adapt", ["tta=sar", "tta.report_no_adapt=true"] + ranks2),
                             ("predict", "predict_ranks", ["training.eval_batch_size=2",
                                                           f"predict.out_dir={root}/ranks"] + ranks2)):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
               f"multimodal_tta_tpu_torch.cli.{call}", *cli_overrides(manifest, os.path.join(root, tag), *extra)]
        t0 = time.perf_counter()
        proc = run_command(cmd, timeout)
        if proc.returncode != 0:
            raise AssertionError(f"torchrun cli.{call} over 2 ranks exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        out[tag] = {"wall_s": time.perf_counter() - t0}
    metrics = json.load(open(os.path.join(root, "adapt", "tta_metrics.json"), encoding="utf-8"))
    out["adapt"]["metrics"] = {k: metrics["adapted"][k] for k in ("gtvt_dc", "avg_hd95", "loss")
                               if k in metrics["adapted"]}
    if not all(math.isfinite(v) for v in out["adapt"]["metrics"].values()) or "no_adapt" not in metrics:
        raise AssertionError(f"torchrun cli.adapt tta=sar metrics {metrics}")
    return out


def ad_predict_check(manifest: str, root: str, torchrun: dict) -> dict:
    """``cli.predict`` in this process at one case a batch against the two
    ranks' export in ``root/ranks`` (``ad_torchrun_cli``): the same
    ``predictions.csv`` and the same masks byte for byte (the NIfTI bytes;
    the gzip header holds a time stamp). Both sides run each convolution on
    a batch of one: cuDNN picks its algorithm by batch size, and a model of
    random weights has many voxels within rounding of the threshold (a
    batch of 2 against 2 x 1 left 0.24% of a mask's voxels apart on an
    H100)."""
    from multimodal_tta_tpu_torch.cli import predict

    out = dict(torchrun)
    t0 = time.perf_counter()
    try:
        rows = predict.main(cli_overrides(manifest, os.path.join(root, "predict_one"), "training.eval_batch_size=1",
                                          f"predict.out_dir={root}/one"))
    finally:
        os.chdir(REPO)  # the run moved into its run directory
    out["predict_one"] = {"wall_s": time.perf_counter() - t0, "cases": len(rows)}
    out["predict"] = r = same_predictions(f"{root}/ranks", f"{root}/one", len(rows))
    if not r["ok"]:
        raise AssertionError(f"cli.predict over two ranks against one process: {r}")
    return out


def adapters_phase(device, root: str, **kw) -> dict:
    """Phase 24: two ranks sharing the device (gloo) against the one-process
    run here on the same global batches: every method's metrics, each
    rank's launches exactly, every norm and min-plus call held to its plain
    version; bf16 ms per evaluated batch. Its command lines are
    ``ad_torchrun_cli`` and ``ad_predict_check``; ``main`` spawns its ranks
    with phases 22-23's (``spawn_pairs``)."""
    prep = adapters_prepare(device, root, **kw)
    spawn_pairs([prep])
    return adapters_finish(prep)


def adapters_prepare(device, root: str, *, shape=SHAPE[:3], channels=(32, 64, 128, 256, 512),
                     threads: int = 4) -> dict:
    """Phase 24 up to its ranks: the data and the ranks' spec."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    spec = {"shape": list(shape), "channels": list(channels), "threads": threads,
            "data": os.path.join(root, "data.pt")}
    torch.save(ad_data(shape, AD_BATCHES), spec["data"])
    spec["ranks_root"] = os.path.join(root, "ranks")
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"name": "adapters", "device": device, "root": root, "t0": t0, "cuda": cuda, "out": {},
            "backend": "gloo", "spec": spec}


def adapters_finish(prep: dict) -> dict:
    """Phase 24 after its ranks: the one-process run and the checks."""
    import shutil

    import torch

    device, root, t0, cuda, out, spec = (prep[k] for k in ("device", "root", "t0", "cuda", "out", "spec"))
    threads = spec["threads"]
    ranks = [torch.load(os.path.join(spec["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(AD_WORLD)]
    out["ranks_s"] = ranks[0]["s"]
    log(f"[adapters] the ranks took {out['ranks_s']:.1f} s")
    t1 = time.perf_counter()
    held = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        one = ad_run(device, None, spec)
    finally:
        torch.set_num_threads(held)
    out["one_s"] = time.perf_counter() - t1
    log(f"[adapters] one process took {out['one_s']:.1f} s")
    failed, compare = [], {}
    for key, o in one["runs"].items():
        method = key.split("_")[0]
        r0 = ranks[0]["runs"][key]
        if any(res["runs"][key]["metrics"] != r0["metrics"] for res in ranks):
            failed.append(f"{key}: the ranks' metrics differ")
        a, b = r0["metrics"], o["metrics"]
        floats = [k for k in b if isinstance(b[k], float)]
        diff = max(abs(a[k] - b[k]) for k in floats)
        if set(a) != set(b) or any(abs(a[k] - b[k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(b[k]) for k in floats):
            failed.append(f"{key}: metrics {a} vs {b}")
        want = ad_expected(method, AD_BATCHES, cuda)
        for res in ranks + [one]:
            if res["runs"][key]["launches"] != want:
                failed.append(f"{key} {res['tag']}: launches {res['runs'][key]['launches']}, derived {want}")
        # the entropies, adapted tensors and teacher after each batch: the
        # ranks' bit for bit, one process's within DP_LOSS_REL / DP_DELTA_REL
        if not all(ad_ranks_equal(res["runs"][key], r0) for res in ranks[1:]):
            failed.append(f"{key}: the ranks' entropies, adapted tensors or teacher differ")
        states = ad_states(r0, o, one["source"])
        if states["ents_max_rel"] > DP_LOSS_REL or max(states["delta_rel_l2"], states["teacher_rel_l2"]) > DP_DELTA_REL:
            failed.append(f"{key}: against one process {states}")
        compare[key] = {"metrics_max_abs": diff, "dice": b.get("gtvt_dc"), "launches": want, **states,
                        "adapted": len(o["adapted"][0]) if o["adapted"] else 0,
                        "teacher": bool(o["teacher"] and o["teacher"][-1])}
        if method == "sar":
            resets = [res["runs"][key]["resets"] for res in ranks + [one]]
            compare[key]["resets"] = resets[-1]
            if len(set(resets)) != 1 or (key.endswith("episodic") and resets[-1] != AD_BATCHES):
                failed.append(f"{key}: SAR's resets {resets}")
    if cuda:
        for res in ranks + [one]:
            if not res["check_ok"]:
                failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    if failed:
        raise AssertionError("phase 24: " + "; ".join(failed))
    out["compare"] = compare
    out["launches"] = {k: sum(res["runs"][key]["launches"][k] for res in ranks for key in res["runs"])
                       for k in ("forward", "backward", "minplus")}
    out["ranks"] = [{k: res[k] for k in ("tag", "check", "bf16_ms", "peak_gib")} for res in ranks]
    out["one"] = {k: one[k] for k in ("check", "bf16_ms", "peak_gib")}
    out["s_by_run"] = {key: (ranks[0]["runs"][key]["s"], one["runs"][key]["s"]) for key in one["runs"]}
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return out


def log_adapters(ad: dict, card: str) -> None:
    log(f"[adapters] phase 24: {AD_WORLD} ranks over gloo on one card vs one process, the flagship at full width, "
        f"TTAEngine.evaluate over {AD_BATCHES} batches of {BATCH}, f32: ranks {ad['ranks_s']:.1f} s, one process "
        f"{ad['one_s']:.1f} s; card {card}")
    for key, c in ad["compare"].items():
        log(f"[adapters]   {key}: metrics within {c['metrics_max_abs']:.3g} of one process (limit {DP_METRIC_ABS} "
            f"+ {DP_METRIC_REL} x |v|), entropies {c['ents_max_rel']:.3g} (limit {DP_LOSS_REL}), the {c['adapted']} "
            f"adapted tensors {c['delta_rel_l2']:.3g}" + (f", the teacher {c['teacher_rel_l2']:.3g}" if c["teacher"] else "")
            + f" of one process's moves (limit {DP_DELTA_REL}; the ranks' bit for bit), Dice {c['dice']}, launches a "
            f"rank {c['launches']}"
            + (f", SAR resets {c['resets']}" if "resets" in c else "")
            + f", s rank/one {ad['s_by_run'][key][0]:.2f}/{ad['s_by_run'][key][1]:.2f}")
    for res in ad["ranks"] + [dict(ad["one"], tag="one")]:
        log(f"[adapters]   {res['tag']}: kernels vs plain {json.dumps(res['check'])}; bf16 ms per evaluated batch "
            f"{({k: round(v, 2) for k, v in res['bf16_ms'].items()})}; peak {res['peak_gib']:.3f} GiB above the memory live "
            f"at the start; card {card}")
    if "torchrun" in ad:
        log(f"[adapters]   torchrun: {json.dumps(ad['torchrun'])}")
    log(f"[adapters] phase 24 took {ad['phase_s']:.1f} s; launches over both ranks {ad['launches']}; card {card}")


# ---- phase 25: the model axis (Megatron heads and MLP) for UNETR ----------------
# four ranks share the one card (gloo) on a data=2 x model=2 mesh: UNETR at
# the width of configs/model/unetr.yaml with tp_axis=model, each model rank
# holding half the heads and MLP features; against one process on the same
# global batches: a forward, two f32 SGD training steps at global batch 4,
# Tent online (continual, inline) and strict (episodic, post) over two
# batches of BATCH. Limits: the forward's logits within TP_LOGIT_REL of the
# largest |logit| (the row-parallel products are summed over the model
# group, in another order than one matmul); the losses and entropies within
# DP_LOSS_REL; the params' and Tent's deltas within DP_DELTA_REL relative L2;
# predictions on DP_PRED_AGREE of voxels
TP_WORLD, TP_MODEL = 4, 2
# configs/model/unetr.yaml's widths, its depth cut from 12 blocks to 8 (the
# axis cuts every block alike; the smoke's time pays for phase 23's
# transformers and phase 27b; UNETR takes a multiple of 4)
TP_UNETR = dict(in_channels=2, num_classes=1, patch_size=16, hidden_size=768, mlp_dim=3072, num_heads=12,
                num_layers=8, feature_size=16)
TP_TRAIN_BATCH = 4
TP_STEPS = 2
TP_TENT_BATCHES = 2
TP_PER_FORWARD = 16  # UNETR's norm calls: skip branches, stem, decoder
TP_LOGIT_REL = 1e-4
TP_SEED = 250
TP_TIMEOUT_S = 900
TP_WEIGHTS = ("query.", "key.", "value.", "out.", "Dense_0.", "Dense_1.")


def tp_run(device, root: str, mesh, spec: dict) -> dict:
    """Phase 25's main path in this process: over the ranks of ``mesh``
    (``data=2 x model=2``), or in one process (``mesh`` None)."""
    import torch
    import torch.distributed as dist

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm
    from multimodal_tta_tpu_torch.models.unetr import UNETR
    from multimodal_tta_tpu_torch.parallel.tensor import shard_model, sharded_params, whole_state_dict
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    data = torch.load(spec["data"], weights_only=False)
    kw = dict(TP_UNETR, **spec.get("model", {}))
    shape = tuple(spec["shape"])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches}

    def since(at):
        return {k: v - at[k] for k, v in counts().items()}

    def rows(x):
        return x if mesh is None else x[mesh.rows(x.shape[0])]

    def gather(t):
        return (t if mesh is None else mesh.gather_rows(t.contiguous())).detach().cpu()

    reduced = {"model": 0, "data": 0, "calls": 0}  # bytes all-reduced by group while ``counting``
    counting = [False]
    all_reduce = dist.all_reduce

    def counted_all_reduce(t, *a, group=None, **k):
        if counting[0]:
            axis = "model" if mesh is not None and group is mesh.model_group else "data"
            reduced[axis] += t.numel() * t.element_size()
            reduced["calls"] += 1
        return all_reduce(t, *a, group=group, **k)

    dist.all_reduce = counted_all_reduce

    def build():
        model = UNETR(**kw, tp_axis="model", image_size=shape, dtype=torch.float32, device=dev, seed=TP_SEED)
        shard_model(model, mesh)
        return model

    out = {"tag": f"rank{mesh.rank}" if mesh is not None else "one", "launches": {}}
    if cuda:  # the peak is read above the memory live at the start (the smoke's earlier phases hold some)
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
    model = build()  # once (an init from the seed takes seconds); each run below starts from its weights
    seed_state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def fresh():
        model.load_state_dict(seed_state)
        model.zero_grad(set_to_none=True)
        return model

    check = CallCheck()  # every norm call of the forward, the training and Tent held to its plain version
    try:
        with check:
            check.on = cuda
            out["tp_bytes"] = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                                  if any(k in n for k in TP_WEIGHTS))
            out["whole_bias_bytes"] = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                                          if n.endswith(("out.bias", "Dense_1.bias")))
            out["sharded"] = len(sharded_params(model))
            # the forward
            x = torch.from_numpy(rows(data["forward"])).to(dev)
            at = counts()
            with torch.no_grad():
                out["logits"] = gather(model(x))
            sync()
            out["launches"]["forward"] = since(at)
            # two f32 SGD steps at global batch TP_TRAIN_BATCH, with cuDNN's
            # default algorithms (as a user runs), then again with
            # deterministic ones: there the whole (replicated) params'
            # gradients of the ranks of a model group must be equal bit for
            # bit, as nothing all-reduces them over the group
            recipe = train_recipe(root)  # the HECKTOR21 recipe's criterion; SGD (a key bias's gradient is rounding)
            recipe["training"].update(optimizer="sgd", compute_dtype="float32", grad_accum=1)
            recipe["training"]["optimizers"]["sgd"] = {"lr": 0.01, "momentum": 0.9}
            cfg = ConfigNode(recipe)

            def timed(fn) -> float:
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                return (time.perf_counter() - t0) * 1e3

            def train(deterministic: bool) -> dict:
                held = torch.backends.cudnn.deterministic
                torch.backends.cudnn.deterministic = deterministic
                m = model if not deterministic else fresh()
                optimizer, lr = build_optimizer(cfg.training, m, mesh)
                trainer = SegTrainer(cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
                trainer.setup(TrainState(model=m, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
                shards = sharded_params(m)
                r = {"init": {k: v.detach().cpu().clone() for k, v in whole_state_dict(m).items()}, "losses": []}
                at = counts()
                for batch in data["train"]:
                    counting[0] = not deterministic and not r["losses"]
                    trainer.run_step(batch)
                    r["losses"].append(trainer.flush_step_metrics()["loss"])
                    sync()
                    counting[0] = False
                    if len(r["losses"]) == 1:  # the first step's summed gradients of the whole params
                        r["replicated_grads"] = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()
                                                 if n not in shards and p.grad is not None}
                        # the bytes the step averages over the model group: those gradients and the loss
                        r["whole_grad_bytes"] = 4 + sum(g.numel() * g.element_size()
                                                        for g in r["replicated_grads"].values())
                r["launches"] = since(at)
                r["params"] = {k: v.detach().cpu().clone() for k, v in whole_state_dict(m).items()}
                if not deterministic and mesh is not None:  # orbax, each rank its cuts; then msgpack, gathered
                    from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint

                    ckpt = os.path.join(spec["ranks_root"], "tp_orbax", "state")
                    t_save = time.perf_counter()
                    save_checkpoint(ckpt, trainer.state, fmt="orbax")
                    r["orbax"] = {"save_s": time.perf_counter() - t_save, "bytes": tree_bytes(
                        os.path.join(ckpt + ".orbax", f"ocdbt.process_{mesh.rank}"))}
                    save_checkpoint(ckpt, trainer.state)
                if not deterministic:  # the same steps again, unchecked and timed
                    check.on, at = False, counts()
                    r["step_ms"] = [timed(lambda b=b: (trainer.run_step(b), trainer.flush_step_metrics()))
                                    for b in data["train"]]
                    r["launches_timed"] = since(at)
                    check.on = cuda
                torch.backends.cudnn.deterministic = held
                return r

            r = train(False)
            out["launches"]["train"] = r.pop("launches")
            out["launches"]["train_timed"] = r.pop("launches_timed")
            out.update(r, step_reduced=dict(reduced))
            det = train(True)
            out["launches"]["train_det"] = det.pop("launches")
            out["det"] = {"losses": det["losses"], "replicated_grads": det["replicated_grads"]}
            # Tent online (continual, inline) and strict (episodic, post) from
            # the init weights; then its batches again, unchecked and timed
            out["tent"] = {}
            for mode, episodic in (("inline", False), ("post", True)):
                model = fresh()  # the seed's weights again
                tcfg = eval_config("tent", episodic)
                tcfg["tta"].update(lr=1e-2, predict=mode)
                tcfg = ConfigNode(tcfg)
                adapter = TentAdapter(tcfg.tta, config=tcfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
                fn = adapter.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode=mode)
                ents, preds = [], []
                at = counts()
                for xb in data["tent"]:
                    _, pred = fn(model, torch.from_numpy(rows(xb)).to(dev), xb.shape[0])
                    preds.append(gather(pred))
                    ents.append(adapter._last_ents.tolist())
                out["launches"][f"tent_{mode}"] = since(at)
                state = whole_state_dict(model)
                adapted = {k: state[k].detach().cpu().clone() for k in adapter._names}
                check.on, at = False, counts()
                ms = [timed(lambda xb=xb: fn(model, torch.from_numpy(rows(xb)).to(dev), xb.shape[0]))
                      for xb in data["tent"]]
                out["launches"][f"tent_{mode}_timed"] = since(at)
                check.on = cuda
                out["tent"][mode] = {"ents": ents, "preds": preds, "ms": ms, "adapted": adapted}
    finally:
        dist.all_reduce = all_reduce
    out["check"] = check.seen
    out["check_ok"] = check.ok(["forward float32", "backward float32"]) if cuda else None
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - live) / 2**30 if cuda else 0.0
    return out


def tp_data(shape) -> dict:
    import numpy as np

    vols = hecktor_volumes(BATCH + TP_STEPS * TP_TRAIN_BATCH + TP_TENT_BATCHES * BATCH, TP_SEED, shape)
    img = np.stack([v["image"] for v in vols])
    lbl = np.stack([v["label"] for v in vols])
    n_train = TP_STEPS * TP_TRAIN_BATCH
    return {"forward": img[:BATCH],
            "train": [{"image": img[BATCH + i * TP_TRAIN_BATCH:BATCH + (i + 1) * TP_TRAIN_BATCH],
                       "label": lbl[BATCH + i * TP_TRAIN_BATCH:BATCH + (i + 1) * TP_TRAIN_BATCH]}
                      for i in range(TP_STEPS)],
            "tent": [img[BATCH + n_train + i * BATCH:BATCH + n_train + (i + 1) * BATCH] for i in range(TP_TENT_BATCHES)]}


def tp_expected(cuda: bool) -> dict:
    """The norm launches of each part of ``tp_run`` (``_timed``: the same
    steps again, unchecked and timed)."""
    n = TP_PER_FORWARD if cuda else 0
    train = {"forward": n * TP_STEPS, "backward": n * TP_STEPS}
    inline = {"forward": n * TP_TENT_BATCHES, "backward": n * TP_TENT_BATCHES}
    post = {"forward": 2 * n * TP_TENT_BATCHES, "backward": n * TP_TENT_BATCHES}
    return {"forward": {"forward": n, "backward": 0}, "train": train, "train_timed": train, "train_det": train,
            "tent_inline": inline, "tent_inline_timed": inline, "tent_post": post, "tent_post_timed": post}


def model_axis_prepare(device, root: str, *, shape=SHAPE[:3], model=None, threads: int = 4) -> dict:
    """Phase 25's data and its one-process run: the ranks' ``spec`` (for
    ``spawn_axes``) and what ``model_axis_compare`` holds them to."""
    import torch

    spec = {"shape": list(shape), "threads": threads, "model": model or {}}
    prep = _prepare(root, spec)
    torch.save(tp_data(shape), spec["data"])
    return _one_process(prep, tp_run, device)


def model_axis_compare(device, prep: dict) -> dict:
    """Phase 25: the four ranks on a ``data=2 x model=2`` mesh (their
    results in ``prep``'s ``ranks_root``) against the one-process run."""
    import torch

    cuda = torch.device(device).type == "cuda"
    one, ranks, out = _ranks_of(prep, "model_axis")
    failed, r0 = [], ranks[0]
    scale = float(one["logits"].abs().max())
    logit_err = max(float((res["logits"] - one["logits"]).abs().max()) for res in ranks)
    if logit_err > TP_LOGIT_REL * scale:
        failed.append(f"the forward's logits {logit_err} from one process's (limit {TP_LOGIT_REL} x {scale})")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
    if any(res["losses"] != r0["losses"] for res in ranks) or loss_rel > DP_LOSS_REL:
        failed.append(f"losses {[res['losses'] for res in ranks]} vs {one['losses']}")
    names = sorted(one["params"])
    d_one = torch.cat([(one["params"][n] - one["init"][n]).flatten() for n in names])
    d_r = torch.cat([(r0["params"][n] - r0["init"][n]).flatten() for n in names])
    delta_rel = float((d_r - d_one).norm() / d_one.norm())
    # how far the ranks' params sit from rank 0's after the default steps
    # (cuDNN's weight gradients need not repeat bit for bit, but the step
    # averages the whole params' over the model group: 0 expected), and the
    # deterministic steps' whole-param gradients, model rank against model rank
    spread = max(float((res["params"][n] - r0["params"][n]).abs().max()) for res in ranks for n in names)
    spread_rel = max(float(torch.cat([(res["params"][n] - r0["params"][n]).flatten() for n in names]).norm()
                           / d_one.norm()) for res in ranks)
    grads_apart = sorted({n for d in range(TP_WORLD // TP_MODEL) for n in ranks[d * TP_MODEL]["det"]["replicated_grads"]
                          for m in range(1, TP_MODEL)
                          if not torch.equal(ranks[d * TP_MODEL + m]["det"]["replicated_grads"][n],
                                             ranks[d * TP_MODEL]["det"]["replicated_grads"][n])})
    det_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["det"]["losses"], one["det"]["losses"]))
    if delta_rel > DP_DELTA_REL:
        failed.append(f"the params' moves over the steps: {delta_rel} (limit {DP_DELTA_REL})")
    if spread != 0.0:  # the whole params' gradients averaged over the model group: one value on every rank
        failed.append(f"the ranks' params apart by {spread} after the default steps (bit for bit expected)")
    if grads_apart or not r0["det"]["replicated_grads"] or det_loss_rel > DP_LOSS_REL:
        failed.append(f"deterministic steps: whole params' gradients apart over a model group {grads_apart[:5]} "
                      f"({len(grads_apart)} tensors), losses {det_loss_rel}")
    tent = {}
    for mode, t in r0["tent"].items():
        o = one["tent"][mode]
        ent_rel = max(abs(a - b) / abs(b) for ea, eb in zip(t["ents"], o["ents"]) for a, b in zip(ea, eb))
        agree = min(float((a == b).float().mean()) for a, b in zip(t["preds"], o["preds"]))
        keys = sorted(o["adapted"])
        diff = torch.cat([(t["adapted"][k] - o["adapted"][k]).flatten() for k in keys])
        delta = torch.cat([(o["adapted"][k] - one["init"][k]).flatten() for k in keys])
        tent[mode] = {"ents_max_rel": ent_rel, "pred_agree": agree, "delta_rel_l2": float(diff.norm() / delta.norm()),
                      "adapted": len(keys), "ms_rank": t["ms"], "ms_one": o["ms"]}
        if ent_rel > DP_LOSS_REL or agree < DP_PRED_AGREE or tent[mode]["delta_rel_l2"] > DP_DELTA_REL:
            failed.append(f"Tent {mode}: {tent[mode]}")
    for res in ranks:
        if res["tp_bytes"] - res["whole_bias_bytes"] != (one["tp_bytes"] - one["whole_bias_bytes"]) // TP_MODEL:
            failed.append(f"{res['tag']} holds {res['tp_bytes']} bytes of attention and MLP weights, one process "
                          f"{one['tp_bytes']}")
    want = tp_expected(cuda)
    for res in ranks + [one]:
        if res["launches"] != want:
            failed.append(f"{res['tag']}: launches {res['launches']}, derived {want}")
        if cuda and not res["check_ok"]:
            failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    # the ranks' orbax file (each rank of the first model group wrote its
    # cuts) read in one process against the gathered msgpack of that state
    orbax = orbax_against_msgpack(os.path.join(prep["spec"]["ranks_root"], "tp_orbax", "state"))
    orbax.update(rank_bytes=[res["orbax"]["bytes"] for res in ranks], save_s=[res["orbax"]["save_s"] for res in ranks])
    if not orbax["bitwise"] or not orbax["rank_bytes"][1] or orbax["rank_bytes"][1] >= orbax["rank_bytes"][0]:
        failed.append(f"the ranks' orbax checkpoint: {orbax}")
    out["orbax"] = orbax
    if failed:
        raise AssertionError("phase 25: " + "; ".join(failed))
    out.update({"ranks_spread_max_abs": spread, "ranks_spread_rel_l2": spread_rel,
                "det_replicated_grads": len(r0["det"]["replicated_grads"]), "det_loss_rel": det_loss_rel})
    out.update({"logit_max_abs": logit_err, "logit_scale": scale, "losses": {"ranks": r0["losses"],
                "one": one["losses"], "max_rel": loss_rel}, "delta_rel_l2": delta_rel, "tent": tent,
                "launches": {k: sum(res["launches"][p][k] for res in ranks for p in want)
                             for k in ("forward", "backward")},
                "ranks": [{k: res[k] for k in ("tag", "tp_bytes", "sharded", "step_ms", "step_reduced",
                                               "whole_grad_bytes", "peak_gib", "check")} for res in ranks],
                "one": {k: one[k] for k in ("tp_bytes", "step_ms", "peak_gib", "check")}})
    return _finish(prep, out)




def model_axis_phase(device, root: str, **kw) -> dict:
    """Phase 25 alone: ``model_axis_prepare``, four ranks sharing the device
    (gloo), ``model_axis_compare``."""
    prep = model_axis_prepare(device, root, **kw)
    spawn_axes(device, [("model_axis", prep["spec"])], os.path.join(root, "store"))
    return model_axis_compare(device, prep)


def log_model_axis(tp: dict, card: str) -> None:
    log(f"[model_axis] phase 25: UNETR {TP_UNETR} with tp_axis=model on {TP_WORLD} ranks (data={TP_WORLD // TP_MODEL}"
        f" x model={TP_MODEL}) over gloo on one card vs one process, f32: ranks {tp['ranks_s']:.1f} s, one process "
        f"{tp['one_s']:.1f} s; card {card}")
    log(f"[model_axis]   forward logits within {tp['logit_max_abs']:.3g} of one process (limit {TP_LOGIT_REL} x "
        f"{tp['logit_scale']:.3g}); losses {tp['losses']}; the params' moves within {tp['delta_rel_l2']:.3g} "
        f"(limit {DP_DELTA_REL}); the ranks' params apart by at most {tp['ranks_spread_max_abs']:.3g} (relative L2 "
        f"{tp['ranks_spread_rel_l2']:.3g} of the moves); with deterministic cuDNN the {tp['det_replicated_grads']} "
        f"whole params' gradients equal on the ranks of each model group (losses {tp['det_loss_rel']:.3g} from one "
        f"process's); Tent {json.dumps(tp['tent'])}")
    for res in tp["ranks"]:
        log(f"[model_axis]   {res['tag']}: {res['tp_bytes']} bytes of attention and MLP weights (one process "
            f"{tp['one']['tp_bytes']}), {res['sharded']} tensors cut; kernels vs plain {json.dumps(res['check'])}; f32 "
            f"step ms (warm, unchecked) {[round(t, 1) for t in res['step_ms']]} (one process "
            f"{[round(t, 1) for t in tp['one']['step_ms']]}); first step all-reduced {res['step_reduced']}"
            f"; peak {res['peak_gib']:.3f} GiB above the memory live at the start (one process "
            f"{tp['one']['peak_gib']:.3f}); card {card}")
    log(f"[model_axis]   one process: kernels vs plain {json.dumps(tp['one']['check'])}")
    o = tp["orbax"]
    log(f"[model_axis]   the trained state as orbax ({o['orbax_bytes']} bytes in all): bytes each rank wrote "
        f"{o['rank_bytes']} (data=2 x model=2: the first model group's two ranks their cuts, rank 0 the whole "
        f"leaves too; the second group's none) in {[round(t, 3) for t in o['save_s']]} s; read in one process in "
        f"{o['read_s']:.3f} s: {o['leaves']} leaves bitwise the gathered msgpack ({o['msgpack_bytes']} bytes): "
        f"{o['bitwise']}; card {card}")
    log(f"[model_axis] phase 25 took {tp['phase_s']:.1f} s; launches over the four ranks {tp['launches']}; card {card}")


# ---- phase 26: the expert axis (MoE experts over ranks) for MoE UNETR ----------
# four ranks share the one card (gloo) on a data=2 x expert=2 mesh: UNETR at
# configs/model/unetr.yaml's width (8 blocks: TP_UNETR) with 8 experts in
# blocks 1, 3, 5, 7 (phase 20's A_unetr_moe8 at 2/3 its depth), remat, f32,
# each rank holding 4 of the 8 experts of every MoE block; against one
# process on the same global batches: a forward, two training steps at
# global batch 4 with Adam and with Adafactor, Tent online and strict, one
# evaluated batch with the surface metrics. Limits: the logits within TP_LOGIT_REL of the largest
# (each rank sums its experts' share of the combine over the expert group,
# in another order than one einsum); losses and entropies within
# DP_LOSS_REL; the first Adam step's gradients (all tensors, and the
# routers') within DP_GRAD_REL relative L2; the first Adafactor step's
# moves of the cut tensors (the experts) within EP_CUT_RULE_REL relative L2
# of the update rule applied uncut to their gathered gradients (the cut
# statistics' sums over the expert group alone); the moves against one
# process's are read, as phase 22 reads them (see expert_axis_compare);
# Tent's moves within DP_DELTA_REL relative L2; the metrics within phase
# 22's limits; the ranks of a data group bit for bit
EP_WORLD, EP_EXPERT = 4, 2
EP_UNETR = dict(TP_UNETR, moe_experts=8, moe_every=2, moe_k=1, moe_capacity_factor=1.25)
EP_TRAIN_BATCH = 4
EP_STEPS = 2
EP_TENT_BATCHES = 2
EP_OPTIMIZERS = ("adam", "adafactor")
EP_SEED = 260
EP_TIMEOUT_S = 900
EP_LEAVES = (".wi", ".bi", ".wo", ".bo")  # the tensors the expert axis cuts (parallel/expert.py)
EP_KEY_BIAS = "key.bias"
EP_CUT_RULE_REL = 1e-5


def ep_config(root: str, optimizer: str, adafactor=None) -> dict:
    """The HECKTOR21 recipe (``train_recipe``) in f32 with ``optimizer`` (the
    stock adam or adafactor block, the latter updated with ``adafactor``)
    and the MoE aux loss."""
    recipe = train_recipe(root)
    recipe["training"].update(optimizer=optimizer, compute_dtype="float32", grad_accum=1, remat=True)
    recipe["training"]["optimizers"]["adafactor"].update(adafactor or {})
    recipe["model"].update(moe_experts=EP_UNETR["moe_experts"])
    return recipe


def ep_expected(cuda: bool) -> dict:
    """The norm and min-plus launches of each part of ``ep_run``: UNETR's 16
    norms a forward, its decoder's 10 recomputed in a remat backward (the 6
    skip-branch norms never are), 16 backward."""
    n, r = (TP_PER_FORWARD, 10) if cuda else (0, 0)

    def parts(fwd: int, bwd: int, minplus: int = 0) -> dict:
        return {"forward": fwd, "backward": bwd, "minplus": minplus}

    train = parts(EP_STEPS * (n + r), EP_STEPS * n)
    return {"forward": parts(n, 0), **{f"train_{o}": train for o in EP_OPTIMIZERS}, "train_timed": train,
            "tent_inline": parts(EP_TENT_BATCHES * (n + r), EP_TENT_BATCHES * n),
            "tent_post": parts(EP_TENT_BATCHES * (2 * n + r), EP_TENT_BATCHES * n),
            "evaluate": parts(2 * n + r, n, 1 if cuda else 0)}


def ep_data(shape) -> dict:
    import numpy as np

    n_train = EP_STEPS * EP_TRAIN_BATCH
    vols = hecktor_volumes(BATCH + n_train + (EP_TENT_BATCHES + 1) * BATCH, EP_SEED, shape)
    img = np.stack([v["image"] for v in vols])
    lbl = np.stack([v["label"] for v in vols])
    at = BATCH + n_train
    return {"forward": img[:BATCH],
            "train": [{"image": img[BATCH + i * EP_TRAIN_BATCH:BATCH + (i + 1) * EP_TRAIN_BATCH],
                       "label": lbl[BATCH + i * EP_TRAIN_BATCH:BATCH + (i + 1) * EP_TRAIN_BATCH]}
                      for i in range(EP_STEPS)],
            "tent": [img[at + i * BATCH:at + (i + 1) * BATCH] for i in range(EP_TENT_BATCHES)],
            "evaluate": [{"image": img[at + EP_TENT_BATCHES * BATCH:], "label": lbl[at + EP_TENT_BATCHES * BATCH:]}]}


def ep_run(device, root: str, mesh, spec: dict) -> dict:
    """Phase 26's main path in this process: over the ranks of ``mesh``
    (``data=2 x expert=2``), or in one process (``mesh`` None), which returns
    its first Adam step's gradients, its first Adafactor step's factored
    moves and their gradients, and its moves for the ranks to read
    (``spec["one"]``: the whole trees are 0.80 GB each)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm
    from multimodal_tta_tpu_torch.models import moe as moe_module
    from multimodal_tta_tpu_torch.models.unetr import UNETR
    from multimodal_tta_tpu_torch.parallel.expert import shard_experts
    from multimodal_tta_tpu_torch.parallel.tensor import sharded_params, whole_state_dict, whole_tensors
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    data = torch.load(spec["data"], weights_only=False)
    kw = dict(EP_UNETR, **spec.get("model", {}))
    shape = tuple(spec["shape"])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches}

    def since(at):
        return {k: v - at[k] for k, v in counts().items()}

    def rows(x):
        return x if mesh is None else x[mesh.rows(x.shape[0])]

    def gather(t):
        return (t if mesh is None else mesh.gather_rows(t.contiguous())).detach().cpu()

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def rel_l2(a: dict, b: dict, keys) -> float:
        return float(torch.cat([(a[k] - b[k]).flatten() for k in keys]).norm()
                     / torch.cat([b[k].flatten() for k in keys]).norm())

    reduced = {"expert": 0, "data": 0, "calls": 0}  # bytes all-reduced by group while ``counting``
    counting = [False]
    all_reduce = dist.all_reduce

    def counted_all_reduce(t, *a, group=None, **k):
        if counting[0]:
            axis = "expert" if mesh is not None and group is mesh.expert_group else "data"
            reduced[axis] += t.numel() * t.element_size()
            reduced["calls"] += 1
        return all_reduce(t, *a, group=group, **k)

    dist.all_reduce = counted_all_reduce
    routed, recording = [], [False]  # the routers' gates of every route call while ``recording``
    route = moe_module.route

    def recorded_route(gates, k):
        if recording[0]:
            routed.append(gates.detach().float().cpu())
        return route(gates, k)

    moe_module.route = recorded_route

    def cut_rule_rel(m, optimizer) -> float:
        """The largest relative L2, over the params this rank holds a share
        of, between their first Adafactor step's whole moves and the update
        rule applied uncut to the whole param and its gathered gradient: what
        the cut statistics' sums over the group add (0.0 with no cut)."""
        from multimodal_tta_tpu_torch.core.optim import Adafactor
        from multimodal_tta_tpu_torch.parallel.tensor import gather_share, sharded_params

        params, worst = dict(m.named_parameters()), 0.0
        for n, (dim, axis) in sorted(sharded_params(m).items(), key=lambda kv: kv[0]):
            p = params[n]
            got = gather_share(p.detach(), dim, axis)  # every rank of the group gathers, in one order
            perm, shape = optimizer._layout(p)
            whole = list(shape)
            whole[optimizer.cuts[id(p)][1]] *= axis.size
            group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
            w0 = init[n].to(dev)
            w = w0.clone()
            w.grad = gather_share(p.grad, dim, axis)
            Adafactor([{"params": [w], "weight_decay": group["weight_decay"]}], lr=group["lr"],
                      layouts={id(w): (perm, tuple(whole))}, min_dim_size_to_factor=optimizer.min_dim_size_to_factor,
                      decay_rate=optimizer.decay_rate, momentum=optimizer.momentum,
                      clipping_threshold=optimizer.clipping_threshold,
                      multiply_by_parameter_scale=optimizer.multiply_by_parameter_scale, eps=optimizer.eps).step()
            worst = max(worst, float((got - w).norm() / (w - w0).norm()))
        return worst

    def factored_moves(m, optimizer):
        """The moves of the params Adafactor factors (a row and a column
        statistic each) and their gradients, whole."""
        params = {n: p for n, p in m.named_parameters() if "v_row" in optimizer.state[p]}
        moves = whole_tensors(m, {n: p.detach() for n, p in params.items()})
        grads = whole_tensors(m, {n: p.grad for n, p in params.items()})
        return {k: v.cpu() - init[k] for k, v in moves.items()}, {k: v.cpu() for k, v in grads.items()}

    def expert_bytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for n, t in tensors if n.endswith(EP_LEAVES))

    # each rank maps the one process's trees (0.80 GB each) rather than copying them in
    one = None if mesh is None else torch.load(spec["one"], map_location="cpu", weights_only=False, mmap=True)
    out = {"tag": f"rank{mesh.rank}" if mesh is not None else "one", "launches": {}, "train": {}, "moves": {}}
    if cuda:  # the peak is read above the memory live at the start (the smoke's earlier phases hold some)
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
    # built once from the seed (the init of 200M params takes seconds); each
    # run below starts from these weights again
    model = UNETR(**kw, image_size=shape, dtype=torch.float32, remat=True, device=dev, seed=EP_SEED)
    shard_experts(model, mesh)
    seed_state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restore():
        model.load_state_dict(seed_state)
        model.zero_grad(set_to_none=True)
        return model

    out["expert_bytes"] = expert_bytes(model.named_parameters())
    out["experts"] = sorted({p.shape[0] for n, p in model.named_parameters() if n.endswith(EP_LEAVES)})
    check = CallCheck()  # every norm and min-plus call of the path held to its plain version
    try:
        with check:
            check.on = cuda
            # the forward
            at = counts()
            with torch.no_grad():
                out["logits"] = gather(model(torch.from_numpy(rows(data["forward"])).to(dev)))
            sync()
            out["launches"]["forward"] = since(at)
            # two f32 steps at global batch EP_TRAIN_BATCH with Adam, then with
            # Adafactor, each from the seed's weights; the first Adam step's
            # collectives counted and its summed gradients kept, then the
            # Adam steps again unchecked for the ms
            init = {k: v.detach().to("cpu", copy=True) for k, v in whole_state_dict(model).items()}
            for opt in EP_OPTIMIZERS:
                m = restore()
                cfg = ConfigNode(ep_config(root, opt, spec.get("adafactor")))
                optimizer, lr = build_optimizer(cfg.training, m, mesh)
                trainer = SegTrainer(cfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
                trainer.setup(TrainState(model=m, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
                r, at = {"losses": []}, counts()
                for batch in data["train"]:
                    counting[0] = recording[0] = opt == "adam" and not r["losses"]
                    trainer.run_step(batch)
                    r["losses"].append(trainer.flush_step_metrics()["loss"])
                    sync()
                    counting[0] = recording[0] = False
                    if opt == "adam" and len(r["losses"]) == 1:
                        grads = {k: v.cpu() for k, v in whole_tensors(m, {n: p.grad for n, p in m.named_parameters()
                                                                            if p.grad is not None}).items()}
                    if opt == "adafactor" and len(r["losses"]) == 1:
                        r["cut_rule_rel"] = cut_rule_rel(m, optimizer)
                        first, first_grads = factored_moves(m, optimizer)
                        r["factored"] = sorted(first)
                        if mesh is None:
                            out["first_moves"], out["first_grads"] = first, first_grads
                        else:
                            keys = sorted(one["first_moves"])
                            experts = [k for k in keys if k.endswith(EP_LEAVES)]
                            r["first_delta_rel_l2"] = rel_l2(first, one["first_moves"], keys)
                            r["first_experts_delta_rel_l2"] = rel_l2(first, one["first_moves"], experts)
                            # each tensor's move and the gradient it was made from
                            r["first_leaves"] = {k: (rel_l2(first, one["first_moves"], [k]),
                                                     rel_l2(first_grads, one["first_grads"], [k])) for k in keys}
                        del first, first_grads
                out["launches"][f"train_{opt}"] = since(at)
                moves = {k: v.detach().cpu() - init[k] for k, v in whole_state_dict(m).items()}
                if mesh is None:
                    out["moves"][opt] = moves
                else:  # against one process's, here: the whole trees stay on the ranks
                    keys = sorted(k for k in moves if not k.endswith(EP_KEY_BIAS))
                    r["delta_rel_l2"] = rel_l2(moves, one["moves"][opt], keys)
                    r["sign_apart"] = float(sum(int((moves[k].sign() != one["moves"][opt][k].sign()).sum())
                                                for k in keys) / sum(moves[k].numel() for k in keys))
                    r["most_apart"] = sorted(((rel_l2(moves, one["moves"][opt], [k]), k) for k in keys),
                                             reverse=True)[:3]
                    r["local_sha"] = [hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
                                      for p in m.parameters()]
                    cut = sharded_params(m)  # the whole params: one value over the expert group
                    r["whole_sha"] = {n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
                                      for n, p in m.named_parameters() if n not in cut}
                if opt == "adam":
                    if mesh is None:
                        out["grads"], out["routed"] = grads, routed
                    else:
                        # the tokens whose expert differs from one process's, route call by
                        # call (the forward's, then remat's), and the widest top-2 gap among them
                        rows_at = rows(torch.arange(EP_TRAIN_BATCH))
                        flipped = [(g.argmax(-1) != w[rows_at].argmax(-1)) for g, w in zip(routed, one["routed"])]
                        out["route_flips"] = [int(f.sum()) for f in flipped]
                        gaps = [w[rows_at].topk(2, dim=-1).values.diff(dim=-1).abs().squeeze(-1)[f]
                                for f, w in zip(flipped, one["routed"])]
                        out["route_flip_gap"] = max((float(g.max()) for g in gaps if g.numel()), default=0.0)
                        out["grad_rel_l2"] = rel_l2(grads, one["grads"], sorted(one["grads"]))
                        out["grad_most_apart"] = sorted(((rel_l2(grads, one["grads"], [k]), k) for k in one["grads"]
                                                         if not k.endswith(EP_KEY_BIAS)), reverse=True)[:3]
                        routers = sorted(k for k in one["grads"] if ".router." in k)
                        out["router_grad_rel_l2"] = rel_l2(grads, one["grads"], routers)
                    inner = getattr(optimizer, "optim", optimizer)
                    r["expert_moment_bytes"] = expert_bytes(
                        (n, v) for n, p in m.named_parameters() for k, v in inner.state[p].items()
                        if k in ("exp_avg", "exp_avg_sq"))
                    check.on, at = False, counts()
                    r["step_ms"] = [timed(lambda b=b: (trainer.run_step(b), trainer.flush_step_metrics()))
                                    for b in data["train"]]
                    out["launches"]["train_timed"] = since(at)
                    check.on = cuda
                out["train"][opt] = r
                del trainer, optimizer, moves
            del init, grads
            out["step_reduced"] = dict(reduced)
            # Tent online (continual, inline) and strict (episodic, post) from the seed's weights
            out["tent"] = {}
            for mode, episodic in (("inline", False), ("post", True)):
                m = restore()
                tcfg = eval_config("tent", episodic)
                tcfg["tta"].update(lr=1e-2, predict=mode)
                tcfg = ConfigNode(tcfg)
                adapter = TentAdapter(tcfg.tta, config=tcfg, device_transform=DEVICE_TRANSFORM, device=dev, mesh=mesh)
                fn = adapter.make_adapt_predict_fn(m, threshold=THRESHOLD, predict_mode=mode)
                ents, preds, at = [], [], counts()
                for xb in data["tent"]:
                    _, pred = fn(m, torch.from_numpy(rows(xb)).to(dev), xb.shape[0])
                    preds.append(gather(pred))
                    ents.append(adapter._last_ents.tolist())
                out["launches"][f"tent_{mode}"] = since(at)
                state = dict(m.named_parameters())
                out["tent"][mode] = {"ents": ents, "preds": preds, "names": list(adapter._names),
                                     "adapted": {k: state[k].detach().cpu().clone() for k in adapter._names},
                                     "experts_grad": any(p.grad is not None for n, p in m.named_parameters()
                                                         if n.endswith(EP_LEAVES))}
            out["source"] = {n: seed_state[n].cpu() for n in out["tent"]["post"]["names"]}
            # one evaluated batch (Tent strict, the surface metrics on the min-plus kernel)
            m = restore()
            engine = TTAEngine(ConfigNode(eval_config("tent", True)), device_transform=DEVICE_TRANSFORM, device=dev,
                               mesh=mesh)
            at = counts()
            out["metrics"] = engine.evaluate(m, data["evaluate"])
            sync()
            out["launches"]["evaluate"] = since(at)
    finally:
        dist.all_reduce = all_reduce
        moe_module.route = route
    out["check"] = check.seen
    out["check_ok"] = check.ok(["forward float32", "backward float32", "minplus"]) if cuda else None
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - live) / 2**30 if cuda else 0.0
    return out


def _max_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def expert_axis_prepare(device, root: str, *, shape=SHAPE[:3], model=None, adafactor=None, threads: int = 4) -> dict:
    """Phase 26's data and its one-process run, whose first Adam step's
    gradients, first Adafactor step's factored moves and their gradients, and
    moves are written for the ranks (``spec["one"]``). ``adafactor`` updates the stock
    Adafactor block (a fixture's narrow tensors factor below its 128)."""
    import torch

    spec = {"shape": list(shape), "threads": threads, "model": model or {}, "adafactor": adafactor or {}}
    prep = _prepare(root, spec)
    spec["one"] = os.path.join(root, "one_moves.pt")
    torch.save(ep_data(shape), spec["data"])
    prep = _one_process(prep, ep_run, device)
    torch.save({k: prep["one"].pop(k) for k in ("moves", "grads", "first_moves", "first_grads", "routed")},
               spec["one"])
    return prep


def expert_axis_compare(device, prep: dict) -> dict:
    """Phase 26: the four ranks on a ``data=2 x expert=2`` mesh against the
    one-process run."""
    import torch

    cuda = torch.device(device).type == "cuda"
    one, ranks, out = _ranks_of(prep, "expert_axis")
    failed, r0 = [], ranks[0]
    scale = float(one["logits"].abs().max())
    logit_err = max(float((res["logits"] - one["logits"]).abs().max()) for res in ranks)
    if logit_err > TP_LOGIT_REL * scale:
        failed.append(f"the forward's logits {logit_err} from one process's (limit {TP_LOGIT_REL} x {scale})")
    # the first Adam step's gradients (all tensors, and the routers') and the
    # first Adafactor step's cut rule are gated; the moves against one
    # process's are read: Adam's first steps, and Adafactor's on a tensor it
    # does not factor (its eps 1e-30 makes that first update sign(g)), move
    # an element by about lr whatever its gradient's size, so an element
    # whose gradient sits within the ranks' rounding moves by +-lr on either
    # side (phase 22's finding); a factored update divides each row, column
    # and expert by its own mean, so one whose gradient is small moves a
    # full step whatever its size too, and the block-RMS clip carries that
    # to the whole tensor (``adafactor_first_most_apart``: the move's and
    # the gradient's distance of the tensors most apart)
    af = one["train"]["adafactor"]["factored"]
    train = {"grad_rel_l2": max(res["grad_rel_l2"] for res in ranks),
             "router_grad_rel_l2": max(res["router_grad_rel_l2"] for res in ranks),
             "grad_most_apart": r0["grad_most_apart"],
             "adafactor_first_delta_rel_l2": max(res["train"]["adafactor"]["first_delta_rel_l2"] for res in ranks),
             "adafactor_first_experts_delta_rel_l2": max(res["train"]["adafactor"]["first_experts_delta_rel_l2"]
                                                         for res in ranks),
             "adafactor_first_most_apart": sorted(((*v, k) for k, v in r0["train"]["adafactor"]["first_leaves"].items()),
                                                  reverse=True)[:4],
             "route_flips": [res["route_flips"] for res in ranks],
             "route_flip_gap": max(res["route_flip_gap"] for res in ranks),
             "adafactor_cut_rule_rel": max(res["train"]["adafactor"]["cut_rule_rel"] for res in ranks),
             "adafactor_factored": len(af), "adafactor_factored_experts": sum(k.endswith((".wi", ".wo")) for k in af)}
    if train["grad_rel_l2"] > DP_GRAD_REL or train["router_grad_rel_l2"] > DP_GRAD_REL:
        failed.append(f"the first step's gradients {train['grad_rel_l2']}, the routers' "
                      f"{train['router_grad_rel_l2']} from one process's (limit {DP_GRAD_REL})")
    if train["adafactor_cut_rule_rel"] > EP_CUT_RULE_REL:
        failed.append(f"the first Adafactor step's moves of the cut tensors {train['adafactor_cut_rule_rel']} from "
                      f"the update rule applied uncut to their gathered gradients (limit {EP_CUT_RULE_REL})")
    if not train["adafactor_factored_experts"] or any(res["train"]["adafactor"]["factored"] != af for res in ranks):
        failed.append(f"Adafactor factors {[res['train']['adafactor']['factored'] for res in ranks]} on the ranks, "
                      f"{af} in one process")
    for opt in EP_OPTIMIZERS:
        t, o = r0["train"][opt], one["train"][opt]
        train[opt] = {"losses": t["losses"], "one": o["losses"], "loss_max_rel": _max_rel(t["losses"], o["losses"]),
                      "delta_rel_l2": max(res["train"][opt]["delta_rel_l2"] for res in ranks),
                      "sign_apart": max(res["train"][opt]["sign_apart"] for res in ranks),
                      "most_apart": t["most_apart"]}
        # the ranks of an expert group may round apart under cuDNN's default
        # algorithms (phase 25's finding): each is held to one process
        train[opt]["loss_max_rel"] = max(_max_rel(res["train"][opt]["losses"], o["losses"]) for res in ranks)
        if train[opt]["loss_max_rel"] > DP_LOSS_REL:
            failed.append(f"{opt} losses {[res['train'][opt]['losses'] for res in ranks]} vs {o['losses']}")
        for e in range(EP_EXPERT):  # ranks (0, e) and (1, e): one data group, the same losses and local params
            a, b = ranks[e]["train"][opt], ranks[EP_EXPERT + e]["train"][opt]
            if a["local_sha"] != b["local_sha"] or a["losses"] != b["losses"]:
                failed.append(f"{opt}: the ranks of data group {e} hold other params or losses")
        # every rank's whole params bit for bit (Mesh.sum_flat averages their
        # gradients over the expert group): an expert group's ranks too
        apart = sorted({n for res in ranks for n, h in res["train"][opt]["whole_sha"].items()
                        if h != r0["train"][opt]["whole_sha"][n]})
        train[opt]["whole_apart"] = len(apart)
        if apart or not r0["train"][opt]["whole_sha"]:
            failed.append(f"{opt}: the whole params differ between the ranks: {apart[:5]} ({len(apart)} tensors)")
    tent = {}
    for mode, t in r0["tent"].items():
        o = one["tent"][mode]
        ent_rel = max(abs(a - b) / abs(b) for ea, eb in zip(t["ents"], o["ents"]) for a, b in zip(ea, eb))
        agree = min(float((a == b).float().mean()) for a, b in zip(t["preds"], o["preds"]))
        keys = sorted(o["adapted"])
        diff = torch.cat([(t["adapted"][k] - o["adapted"][k]).flatten() for k in keys])
        delta = torch.cat([(o["adapted"][k] - one["source"][k]).flatten() for k in keys])
        tent[mode] = {"ents_max_rel": ent_rel, "pred_agree": agree, "delta_rel_l2": float(diff.norm() / delta.norm()),
                      "adapted": len(keys), "experts_adapted": any(k.endswith(EP_LEAVES) for k in keys)}
        if (ent_rel > DP_LOSS_REL or agree < DP_PRED_AGREE or tent[mode]["delta_rel_l2"] > DP_DELTA_REL
                or t["names"] != o["names"] or tent[mode]["experts_adapted"]
                or any(res["tent"][mode]["experts_grad"] for res in ranks)):
            failed.append(f"Tent {mode}: {tent[mode]}")
    a, b = r0["metrics"], one["metrics"]
    floats = [k for k in b if isinstance(b[k], float)]
    metrics_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0) for k in floats)
    if (set(a) != set(b) or any(res["metrics"] != a for res in ranks)
            or any(abs(a[k] - b[k]) > DP_METRIC_ABS + DP_METRIC_REL * abs(b[k]) for k in floats)):
        failed.append(f"evaluate: metrics {a} vs {b}")
    for res in ranks:
        if res["experts"] != [one["experts"][0] // EP_EXPERT] or res["expert_bytes"] * EP_EXPERT != one["expert_bytes"]:
            failed.append(f"{res['tag']} holds experts {res['experts']}, {res['expert_bytes']} bytes (one process "
                          f"{one['expert_bytes']})")
        if res["train"]["adam"]["expert_moment_bytes"] * EP_EXPERT != one["train"]["adam"]["expert_moment_bytes"]:
            failed.append(f"{res['tag']} holds {res['train']['adam']['expert_moment_bytes']} bytes of expert moments "
                          f"(one process {one['train']['adam']['expert_moment_bytes']})")
    want = ep_expected(cuda)
    for res in ranks + [one]:
        if res["launches"] != want:
            failed.append(f"{res['tag']}: launches {res['launches']}, derived {want}")
        if cuda and not res["check_ok"]:
            failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    if failed:
        raise AssertionError("phase 26: " + "; ".join(failed))
    out.update({"logit_max_abs": logit_err, "logit_scale": scale, "train": train, "tent": tent,
                "evaluate": {"metrics": b, "metrics_max_rel": metrics_rel},
                "launches": {k: sum(res["launches"][p][k] for res in ranks for p in want)
                             for k in ("forward", "backward", "minplus")},
                "ranks": [{"tag": res["tag"], "expert_bytes": res["expert_bytes"],
                           "expert_moment_bytes": res["train"]["adam"]["expert_moment_bytes"],
                           "step_ms": res["train"]["adam"]["step_ms"], "step_reduced": res["step_reduced"],
                           "peak_gib": res["peak_gib"], "check": res["check"]} for res in ranks],
                "one": {"expert_bytes": one["expert_bytes"],
                        "expert_moment_bytes": one["train"]["adam"]["expert_moment_bytes"],
                        "step_ms": one["train"]["adam"]["step_ms"], "peak_gib": one["peak_gib"],
                        "check": one["check"]}})
    return _finish(prep, out)




def expert_axis_phase(device, root: str, **kw) -> dict:
    """Phase 26 alone: ``expert_axis_prepare``, four ranks sharing the
    device (gloo), ``expert_axis_compare``."""
    prep = expert_axis_prepare(device, root, **kw)
    spawn_axes(device, [("expert_axis", prep["spec"])], os.path.join(root, "store"))
    return expert_axis_compare(device, prep)


def log_expert_axis(ep: dict, card: str) -> None:
    log(f"[expert_axis] phase 26: MoE UNETR {EP_UNETR} with remat on {EP_WORLD} ranks (data={EP_WORLD // EP_EXPERT} "
        f"x expert={EP_EXPERT}) over gloo on one card vs one process, f32: one process {ep['one_s']:.1f} s, ranks "
        f"{ep['ranks_s']:.1f} s; card {card}")
    log(f"[expert_axis]   forward logits within {ep['logit_max_abs']:.3g} of one process (limit {TP_LOGIT_REL} x "
        f"{ep['logit_scale']:.3g}); training {json.dumps(ep['train'])}; Tent {json.dumps(ep['tent'])}; evaluate "
        f"{json.dumps(ep['evaluate'])}")
    for res in ep["ranks"]:
        log(f"[expert_axis]   {res['tag']}: {res['expert_bytes']} bytes of experts (one process "
            f"{ep['one']['expert_bytes']}), {res['expert_moment_bytes']} bytes of their Adam moments (one process "
            f"{ep['one']['expert_moment_bytes']}); kernels vs plain {json.dumps(res['check'])}; f32 Adam step ms "
            f"(warm, unchecked) {[round(t, 1) for t in res['step_ms']]} (one process "
            f"{[round(t, 1) for t in ep['one']['step_ms']]}); first Adam step all-reduced {res['step_reduced']}; peak "
            f"{res['peak_gib']:.3f} GiB above the memory live at the start (one process {ep['one']['peak_gib']:.3f}); "
            f"card {card}")
    log(f"[expert_axis]   one process: kernels vs plain {json.dumps(ep['one']['check'])}")
    log(f"[expert_axis] phase 26 took {ep['phase_s']:.1f} s; launches over the four ranks {ep['launches']}; card {card}")


# ---- phase 27: the stage axis (GPipe) for ViT-B/16 -----------------------------
# four ranks share the one card (gloo) on a data=2 x stage=2 mesh: ViT-B/16
# at configs/model/vit.yaml's width (patch 16, hidden 768, depth 12, 12
# heads, MLP 3072, 1000 classes) on [64,224,224,3] in f32 with TF32 off,
# n_micro=4 (each data rank's microbatch slice [8,197,768]); each stage
# holds 6 blocks. Against the sequential model in one process:
# vit_forward_pipelined's logits within PP_LOGIT_REL of the largest (the
# reference's 1e-4: the pipeline applies the same layers in the same
# order, so it should sit at rounding); two make_pipeline_train_step SGD
# steps on the trunk (remat; the loss the head's cross-entropy), the first
# step's loss within PP_LOSS_REL and each stacked leaf's gradient within
# PP_GRAD_REL of that leaf's largest in the sequential step (all but the
# attention key bias, whose gradient is rounding), the second loss below
# the first. The trunk launches neither kernel (LayerNorms only).
PP_WORLD, PP_STAGES = 4, 2
PP_VIT = dict(variant="vit_b_16", num_classes=1000, patch=16, hidden=768, depth=12, heads=12, mlp_dim=3072)
PP_BATCH, PP_SIDE, PP_MICRO = 64, 224, 4
PP_LR, PP_MOMENTUM = 0.1, 0.9
PP_LOGIT_REL, PP_LOSS_REL, PP_GRAD_REL = 1e-4, 1e-5, 1e-4
PP_SEED = 270
PP_TIMED = 3
PP_TIMEOUT_S = 600


def pp_model(spec: dict, dev):
    import torch

    from multimodal_tta_tpu_torch.models.vit import ViT

    kw = dict(PP_VIT, **spec.get("model", {}))
    return ViT(**kw, image_size=spec["side"], dtype=torch.float32, device=dev, seed=PP_SEED)


def pp_trunk(model):
    """The trunk's layer function, its stacked blocks (leaves) and the loss
    of its output: the head's cross-entropy (the head fixed)."""
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from multimodal_tta_tpu_torch.parallel.pipeline import stack_layer_params

    template = model.block0
    stacked = {k: v.detach().clone().requires_grad_() for k, v in
               stack_layer_params(dict(model.named_parameters()), "block", model.depth).items()}

    def layer_fn(p, tokens):
        return functional_call(template, p, (tokens,))

    def loss_fn(y, labels):
        return F.cross_entropy(model.head_of(y)[1], labels)

    for p in model.parameters():
        p.requires_grad_(False)
    return layer_fn, stacked, loss_fn


def pp_run(device, root: str, mesh, spec: dict) -> dict:
    """Phase 27's main path over the ranks of ``mesh`` (``data=2 x
    stage=2``), or the sequential model in one process (``mesh`` None),
    which writes what the ranks compare with (``spec["one"]``). ``spec``'s
    ``steps``: its GPipe steps (2)."""
    import torch
    import torch.distributed as dist

    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm
    from multimodal_tta_tpu_torch.parallel.pipeline import (gather_stages, make_pipeline_train_step, stage_params,
                                                            vit_forward_pipelined)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    cuda = dev.type == "cuda"
    data = torch.load(spec["data"], weights_only=False)
    x, labels = torch.from_numpy(data["x"]).to(dev), torch.from_numpy(data["labels"]).to(dev)
    n_steps = spec.get("steps", 2)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    hops = {"sends": 0, "bytes": 0}
    send = dist.send

    def counted_send(t, *a, **k):
        hops["sends"] += 1
        hops["bytes"] += t.numel() * t.element_size()
        return send(t, *a, **k)

    dist.send = counted_send
    launches0 = (fused_instance_norm.launches, fused_instance_norm.backward_launches)
    out = {"tag": f"rank{mesh.rank}" if mesh is not None else "one"}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
    try:
        model = pp_model(spec, dev)
        with torch.no_grad():
            if mesh is None:
                _, logits = model(x)
                out["forward_ms"] = [timed(lambda: model(x)) for _ in range(PP_TIMED)]
            else:
                _, logits = vit_forward_pipelined(model, x, mesh, n_micro=PP_MICRO)
                out["forward_hops"] = dict(hops)
                out["forward_ms"] = [timed(lambda: vit_forward_pipelined(model, x, mesh, n_micro=PP_MICRO))
                                     for _ in range(PP_TIMED)]
            h0 = model.embed(x)
        layer_fn, stacked, loss_fn = pp_trunk(model)
        if mesh is None:
            params = stacked
            opt = torch.optim.SGD(list(params.values()), lr=PP_LR, momentum=PP_MOMENTUM)

            def step(ps, h, t):
                opt.zero_grad(set_to_none=True)
                y = h
                for i in range(model.depth):
                    y = layer_fn({k: v[i] for k, v in ps.items()}, y)
                loss = loss_fn(y, t)
                loss.backward()
                opt.step()
                return loss.detach()
        else:
            params = stage_params(mesh, stacked)
            opt = torch.optim.SGD(list(params.values()), lr=PP_LR, momentum=PP_MOMENTUM)
            step = make_pipeline_train_step(mesh, layer_fn, loss_fn, opt, n_micro=PP_MICRO, remat=True)
        out["block_bytes"] = sum(v.numel() * v.element_size() for v in params.values())
        losses = [float(step(params, h0, labels))]
        grads = {k: v.grad.detach() for k, v in params.items()}
        if mesh is not None:
            grads = gather_stages(mesh, grads)
        if n_steps > 1:
            losses.append(float(step(params, h0, labels)))
        out["train_ms"] = [timed(lambda: step(params, h0, labels)) for _ in range(PP_TIMED)]
        out["losses"] = losses
        if mesh is None:
            out["logits"] = logits.cpu()
            torch.save({"logits": logits.cpu(), "grads": {k: v.cpu() for k, v in grads.items()}, "losses": losses},
                       spec["one"])
        else:
            one = torch.load(spec["one"], map_location=dev, weights_only=False)
            out["logits_max_rel"] = float((logits - one["logits"]).abs().max() / one["logits"].abs().max())
            # each stacked leaf against its own largest gradient, but the
            # attention key bias: softmax is blind to it, so its gradient is rounding
            per_leaf = {k: float((grads[k] - g).abs().max() / g.abs().max()) for k, g in one["grads"].items()
                        if not k.endswith("key.bias")}
            out["grad_rel_leaf"] = max(per_leaf, key=per_leaf.get)
            out["grad_rel"] = per_leaf[out["grad_rel_leaf"]]
            out["loss_rel"] = abs(losses[0] - one["losses"][0]) / abs(one["losses"][0])
            if n_steps > 1:
                out["second_loss_rel"] = abs(losses[1] - one["losses"][1]) / abs(one["losses"][1])
        out["launches"] = {"forward": fused_instance_norm.launches - launches0[0],
                           "backward": fused_instance_norm.backward_launches - launches0[1]}
    finally:
        dist.send = send
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - live) / 2**30 if cuda else 0.0
    return out


def stage_axis_prepare(device, root: str, *, batch: int = PP_BATCH, side: int = PP_SIDE, model=None,
                       threads: int = 4) -> dict:
    """Phase 27's data and the sequential ViT in one process, whose logits,
    losses and stacked gradients are written for the ranks (``spec["one"]``)."""
    import numpy as np
    import torch

    spec = {"side": side, "threads": threads, "model": model or {}, "batch": batch}
    prep = _prepare(root, spec)
    spec["one"] = os.path.join(root, "one.pt")
    rng = np.random.RandomState(PP_SEED)
    classes = dict(PP_VIT, **(model or {}))["num_classes"]
    torch.save({"x": rng.randn(batch, side, side, 3).astype(np.float32),
                "labels": rng.randint(0, classes, size=batch).astype(np.int64)}, spec["data"])
    return _one_process(prep, pp_run, device)


def stage_axis_compare(device, prep: dict) -> dict:
    """Phase 27: the four ranks on a ``data=2 x stage=2`` mesh against the
    sequential model."""
    one, ranks, out = _ranks_of(prep, "stage_axis")
    spec = prep["spec"]
    batch, side, model = spec["batch"], spec["side"], spec["model"]
    failed = []
    depth = dict(PP_VIT, **(model or {}))["depth"]
    mbl = batch // PP_MICRO // (PP_WORLD // PP_STAGES)
    tokens = (side // dict(PP_VIT, **(model or {}))["patch"]) ** 2 + 1
    hop_bytes = mbl * tokens * dict(PP_VIT, **(model or {}))["hidden"] * 4
    out.update({"logits_max_rel": max(r["logits_max_rel"] for r in ranks),
                "train": {"losses": ranks[0]["losses"], "one": one["losses"],
                          "loss_rel": max(r["loss_rel"] for r in ranks),
                          "second_loss_rel": max(r["second_loss_rel"] for r in ranks),
                          "grad_rel": max(r["grad_rel"] for r in ranks),
                          "grad_rel_leaf": max(ranks, key=lambda r: r["grad_rel"])["grad_rel_leaf"]},
                "bubble": (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1), "hop_bytes": hop_bytes})
    if out["logits_max_rel"] > PP_LOGIT_REL:
        failed.append(f"the pipelined logits {out['logits_max_rel']} of the largest from the sequential ones "
                      f"(limit {PP_LOGIT_REL})")
    tr = out["train"]
    if tr["loss_rel"] > PP_LOSS_REL or tr["grad_rel"] > PP_GRAD_REL or not tr["losses"][1] < tr["losses"][0]:
        failed.append(f"training: {tr} (limits {PP_LOSS_REL}, {PP_GRAD_REL}, the second loss below the first)")
    for r, res in enumerate(ranks):
        last = r % PP_STAGES == PP_STAGES - 1
        want = {"sends": 0 if last else PP_MICRO, "bytes": 0 if last else PP_MICRO * hop_bytes}
        if res["block_bytes"] * PP_STAGES != one["block_bytes"]:
            failed.append(f"{res['tag']} holds {res['block_bytes']} bytes of blocks (one process {one['block_bytes']}"
                          f", {depth} blocks)")
        if res["forward_hops"] != want:
            failed.append(f"{res['tag']}: hops of a forward {res['forward_hops']}, derived {want}")
        if any(res["launches"].values()):
            failed.append(f"{res['tag']}: the ViT launched the norm kernel: {res['launches']}")
    if failed:
        raise AssertionError("phase 27: " + "; ".join(failed))
    out["ranks"] = [{k: res[k] for k in ("tag", "block_bytes", "forward_ms", "train_ms", "forward_hops", "peak_gib")}
                    for res in ranks]
    out["one"] = {k: one[k] for k in ("block_bytes", "forward_ms", "train_ms", "peak_gib")}
    return _finish(prep, out)




def stage_axis_phase(device, root: str, **kw) -> dict:
    """Phase 27 alone: ``stage_axis_prepare``, four ranks sharing the
    device (gloo), ``stage_axis_compare``."""
    prep = stage_axis_prepare(device, root, **kw)
    spawn_axes(device, [("stage_axis", prep["spec"])], os.path.join(root, "store"))
    return stage_axis_compare(device, prep)


def log_stage_axis(pp: dict, card: str) -> None:
    log(f"[stage_axis] phase 27: ViT {PP_VIT} on [{PP_BATCH},{PP_SIDE},{PP_SIDE},3] f32 (TF32 off) on {PP_WORLD} ranks "
        f"(data={PP_WORLD // PP_STAGES} x stage={PP_STAGES}), n_micro={PP_MICRO}, over gloo on one card vs the "
        f"sequential model: one process {pp['one_s']:.1f} s, ranks {pp['ranks_s']:.1f} s; card {card}")
    log(f"[stage_axis]   pipelined logits within {pp['logits_max_rel']:.3g} of the largest sequential one (limit "
        f"{PP_LOGIT_REL}); GPipe SGD steps {json.dumps(pp['train'])}; bubble {pp['bubble']:.3f}; "
        f"{pp['hop_bytes']} bytes a hop (hops through pinned host memory: gloo); card {card}")
    for res in pp["ranks"]:
        log(f"[stage_axis]   {res['tag']}: {res['block_bytes']} bytes of blocks (one process "
            f"{pp['one']['block_bytes']}); pipelined forward ms {[round(t, 1) for t in res['forward_ms']]} (sequential "
            f"{[round(t, 1) for t in pp['one']['forward_ms']]}); GPipe step ms {[round(t, 1) for t in res['train_ms']]}"
            f" (sequential {[round(t, 1) for t in pp['one']['train_ms']]}); hops a forward {res['forward_hops']}; "
            f"peak {res['peak_gib']:.3f} GiB (one process {pp['one']['peak_gib']:.3f}); card {card}")
    log(f"[stage_axis] phase 27 took {pp['phase_s']:.1f} s; no kernel on this path (the ViT has LayerNorms only); "
        f"card {card}")


# ---- phase 27b: a space axis beside the model, expert and stage axes --------------
# the same four ranks (gloo, card 0), one mesh a case, f32 (TF32 off), widths
# kept and depth cut, against one process (run first: its logits, loss,
# gradients and routing written once for the ranks to read): UNETR with
# tp_axis=model and seq_shard_axis=space on one BraTS volume over
# space=2 x model=2 (4 encoder blocks: 1200 tokens, 600 a space rank, half
# the heads and MLP features a model rank), a forward and one SGD step; the
# flagship with 4 bottleneck experts on one HECKTOR21 batch over
# space=2 x expert=2 (2 experts a rank), the routing of a training forward
# (the dispatch tensor, token for token) and one SGD step; ViT-B/16
# pipelined over space=2 x stage=2 (the space ranks replicas, as the
# reference's x_spec = P(None, data)), one GPipe step against phase 27's
# sequential run, then its forward and step timed. Every norm call held to
# its plain version as the path makes it (SplitCheck, CallCheck); each
# rank's launches derived from NormLevels
SX_CASES = ("unetr_seq_model", "flagship_expert")
AXES_SPACE_CASES = SX_CASES + ("vit_stage",)
SX_MESHES = {"unetr_seq_model": dict(data=1, space=2, model=2), "flagship_expert": dict(data=1, space=2, expert=2),
             "vit_stage": dict(data=1, space=2, stage=2)}
SX_UNETR = dict(TP_UNETR, in_channels=4, num_classes=3, num_layers=4, seq_shard_axis="space")
SX_EXPERTS = 4
SX_SEED = 290
SX_TIMEOUT_S = 600


def sx_models(spec: dict) -> dict:
    """Each case's model node and image size (``spec``'s overrides: the CPU
    tests' fixture size)."""
    unetr = dict(SX_UNETR, name="unetr", tp_axis="model", **spec.get("unetr", {}))
    flagship = dict(model_node("unet"), moe_experts=SX_EXPERTS, **spec.get("flagship", {}))
    return {"unetr_seq_model": (unetr, list(spec["unetr_shape"]), MID_CRITERION, {"normalize": False}, "brats"),
            "flagship_expert": (flagship, list(spec["flagship_shape"]), None, DEVICE_TRANSFORM, "hecktor")}


def sx_run(device, root: str, meshes, spec: dict) -> dict:
    """Phase 27b in this process: each case over the ranks of its mesh
    (``meshes[case]``), or in one process (``meshes`` None), which writes
    what the ranks compare with (``spec["one"]``); the pipelined ViT over
    ``space=2 x stage=2`` through ``pp_run`` against phase 27's sequential
    run (``spec["pipeline"]``)."""
    import torch

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.models import moe as moe_module
    from multimodal_tta_tpu_torch.models.layers import capture_intermediates, pool_over_ranks
    from multimodal_tta_tpu_torch.ops.intensity import make_intensity_normalizer
    from multimodal_tta_tpu_torch.parallel import space as sp
    from multimodal_tta_tpu_torch.parallel.expert import shard_experts
    from multimodal_tta_tpu_torch.parallel.tensor import shard_model, sharded_params, whole_tensors
    from multimodal_tta_tpu_torch.registry import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = torch.load(spec["data"], weights_only=False)
    recipe = train_recipe(os.path.join(root, "recipe"))["training"]["criterion"]
    one = None if meshes is None else torch.load(spec["one"], weights_only=False)
    tag = "one" if meshes is None else f"rank{next(iter(meshes.values())).rank}"
    out = {"tag": tag, "cases": {}}
    split, calls = SplitCheck(), CallCheck()
    saved = {}
    for name, (node, image_size, criterion, transform, key) in sx_models(spec).items():
        mesh = None if meshes is None else meshes[name]
        dev = mesh.device if mesh is not None else torch.device(device)
        cuda = dev.type == "cuda"
        calls.on = cuda
        batch = data[key]
        local = (lambda t: t) if mesh is None else mesh.local
        gather = (lambda t: t) if mesh is None else mesh.gather

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        def mark() -> dict:
            """The launch counters and the plain backward calls CallCheck itself made."""
            return dict(split_counts(), checked=calls.backward_calls())

        def since(at: dict) -> dict:
            sync()
            now = mark()
            out = {k: v - at[k] for k, v in now.items() if k != "checked"}
            out["plain_backward"] -= now["checked"] - at["checked"]
            return out

        def build():
            cfg = ConfigNode(sm_config(node, criterion or recipe, "float32",
                                       data={"transforms": {"image_size": image_size}}))
            cls = get_model(node["name"])
            sized = {"image_size": image_size} if getattr(cls, "input_sized", False) else {}
            model = cls.from_config(cfg.model, dtype=torch.float32, remat=False, device=dev, seed=SX_SEED, **sized)
            shard_model(model, mesh)  # this rank's heads and MLP features (model axis)
            shard_experts(model, mesh)  # this rank's experts (expert axis)
            optimizer, lr = build_optimizer(cfg.training, model, mesh)
            trainer = SegTrainer(cfg, device_transform=transform, device=dev, mesh=mesh)
            trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
            return model, trainer

        def step(trainer):
            """One ``run_step``: its loss and the whole gradients it applied
            (summed over data x space, the cut ones gathered), flat in sorted
            name order, on the CPU."""
            grads, apply = {}, trainer.state.apply_gradients
            model = trainer.state.model

            def first():
                whole = whole_tensors(model, {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
                grads["names"] = sorted(whole)
                grads["flat"] = torch.cat([whole[n].detach().flatten() for n in grads["names"]]).cpu()
                trainer.state.apply_gradients = apply
                return apply()

            trainer.state.apply_gradients = first
            trainer.run_step({"image": batch["image"], "label": batch["label"]})
            return trainer.flush_step_metrics()["loss"], grads

        model, trainer = build()
        r = {"launches": {}, "sharded": len(sharded_params(model))}
        norm_fn = make_intensity_normalizer(normalize=transform.get("normalize", False),
                                            intensity_policy=transform.get("intensity_policy"),
                                            channel_names=transform.get("channel_names"))
        seen = []
        routed = moe_module.dispatch_combine

        def recording(gates, k, cap, space=None):
            got = routed(gates, k, cap, space)
            d = got[0].detach()
            seen.append(sp.all_gather_cat(d.contiguous(), 1, space.size, space.group) if space is not None else d)
            return got

        with split, calls, NormLevels(model) as levels:
            at = mark()
            moe_module.dispatch_combine = recording
            model.train(bool(node.get("moe_experts")))  # the routing of a training forward
            pool_over_ranks(model, mesh)
            try:
                with torch.no_grad(), sp.sharded(mesh), capture_intermediates():
                    x = norm_fn(torch.from_numpy(local(batch["image"])).to(dev), space=sp.axis_of(mesh))
                    logits = gather(model(x)).cpu()
            finally:
                moe_module.dispatch_combine = routed
                model.eval()
            r["launches"]["forward"] = since(at)
            dispatch = [d.cpu() for d in seen]
            at = mark()
            loss, grads = step(trainer)
            r["launches"]["train"] = since(at)
        r["norms"] = {"split": len(levels.split), "whole": len(levels.whole)}
        r["loss"] = loss
        if meshes is None:
            saved[name] = {"logits": logits, "loss": loss, "grads": grads, "dispatch": dispatch}
        else:
            o = one[name]
            r["logits_rel_l2"] = float((logits - o["logits"]).norm() / o["logits"].norm())
            r["loss_rel"] = abs(loss - o["loss"]) / abs(o["loss"])
            r["grad_rel_l2"] = float((grads["flat"] - o["grads"]["flat"]).norm() / o["grads"]["flat"].norm()) \
                if grads["names"] == o["grads"]["names"] else float("inf")
            r["dispatch_equal"] = len(dispatch) == len(o["dispatch"]) and all(
                torch.equal(a, b) for a, b in zip(dispatch, o["dispatch"]))
            r["moe_blocks"] = len(dispatch)
        del model, trainer
        if cuda:
            torch.cuda.empty_cache()
        out["cases"][name] = r
    if meshes is None:
        torch.save(saved, spec["one"])
    else:  # one GPipe step over space=2 x stage=2 against the sequential run
        out["cases"]["vit_stage"] = pp_run(device, root, meshes["vit_stage"], spec["pipeline"])
    cuda = torch.device(device).type == "cuda"
    out["check"] = {"split": split.seen, "calls": calls.seen}
    out["check_ok"] = (meshes is None or split.ok()) and (
        not cuda or calls.ok(["forward float32", "backward float32"]))
    return out


def sx_expected(res: dict, cuda: bool) -> dict:
    """Each case's launches by part, derived from the norms that ran split
    and whole: a forward takes the one-launch kernel for each whole norm and
    stats + apply for each split one; a training step one forward and a
    backward (the backward kernel for each whole norm, bwd_sums + bwd_apply
    for each split one)."""
    out = {}
    for name in SX_CASES:
        r = res["cases"][name]
        s, w = (r["norms"]["split"], r["norms"]["whole"]) if cuda else (0, 0)

        def launches(fwd=0, bwd=0):
            return {"forward": w * fwd, "backward": w * bwd, "minplus": 0, "plain_backward": 0,
                    "instance_norm_stats": s * fwd, "instance_norm_apply": s * fwd,
                    "instance_norm_bwd_sums": s * bwd, "instance_norm_bwd_apply": s * bwd}

        out[name] = {"forward": launches(fwd=1), "train": launches(fwd=1, bwd=1)}
    return out


def space_axes_prepare(device, root: str, *, unetr=None, unetr_shape=BRATS_SHAPE, flagship=None,
                       flagship_shape=SHAPE[:3], pipeline=None, vit=None, vit_side: int = PP_SIDE,
                       vit_batch: int = PP_BATCH, threads: int = 4) -> dict:
    """Phase 27b's data and its one process, whose results are written for
    the ranks (``spec["one"]``); ``pipeline``: phase 27's spec, whose
    sequential run the pipelined case compares with (None: its own,
    ``stage_axis_prepare`` at ``vit`` / ``vit_side`` / ``vit_batch``)."""
    import torch

    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes

    spec = {"unetr": dict(unetr or {}), "unetr_shape": list(unetr_shape), "flagship": dict(flagship or {}),
            "flagship_shape": list(flagship_shape), "threads": threads}
    prep = _prepare(root, spec)
    spec["one"] = os.path.join(root, "one.pt")
    torch.save({"brats": _stack(brats_volumes(1, tuple(unetr_shape), seed=SX_SEED)),
                "hecktor": _stack(hecktor_volumes(BATCH, SX_SEED, tuple(flagship_shape)))}, spec["data"])
    if pipeline is None:
        prep["pipeline_prep"] = stage_axis_prepare(device, os.path.join(root, "pipeline"), batch=vit_batch,
                                                   side=vit_side, model=vit, threads=threads)
        pipeline = prep["pipeline_prep"]["spec"]
    spec["pipeline"] = dict(pipeline, steps=1)
    return _one_process(prep, sx_run, device)


def space_axes_compare(device, prep: dict) -> dict:
    """Phase 27b: the four ranks, one mesh a case, against one process."""
    import shutil

    import torch

    one, ranks, out = _ranks_of(prep, "space_axes")
    cuda = torch.device(device).type == "cuda"
    failed, cases = [], {}
    for name in SX_CASES:
        rs = [res["cases"][name] for res in ranks]
        c = {k: max(r[k] for r in rs) for k in ("logits_rel_l2", "loss_rel", "grad_rel_l2")}
        c.update(loss=[rs[0]["loss"], one["cases"][name]["loss"]], sharded=[r["sharded"] for r in rs],
                 norms=rs[0]["norms"], launches=rs[0]["launches"], dispatch_equal=all(r["dispatch_equal"] for r in rs),
                 moe_blocks=rs[0]["moe_blocks"])
        c["ok"] = (c["logits_rel_l2"] <= ST_LOGIT_REL and c["loss_rel"] <= SP_LOSS_REL
                   and c["grad_rel_l2"] <= SP_GRAD_REL and c["dispatch_equal"] and all(c["sharded"])
                   and (c["moe_blocks"] > 0) == (name == "flagship_expert"))
        if not c["ok"]:
            failed.append(f"{name}: {c}")
        cases[name] = c
    pp = [res["cases"]["vit_stage"] for res in ranks]
    c = {"logits_max_rel": max(r["logits_max_rel"] for r in pp), "loss_rel": max(r["loss_rel"] for r in pp),
         "grad_rel": max(r["grad_rel"] for r in pp), "grad_rel_leaf": max(pp, key=lambda r: r["grad_rel"])["grad_rel_leaf"],
         "losses": pp[0]["losses"], "forward_hops": [r["forward_hops"] for r in pp],
         "forward_ms": pp[0]["forward_ms"], "train_ms": pp[0]["train_ms"]}
    c["ok"] = c["logits_max_rel"] <= PP_LOGIT_REL and c["loss_rel"] <= PP_LOSS_REL and c["grad_rel"] <= PP_GRAD_REL \
        and all(r["logits_max_rel"] == pp[0]["logits_max_rel"] for r in pp[::PP_STAGES])
    if not c["ok"]:
        failed.append(f"vit_stage: {c}")
    cases["vit_stage"] = c
    for res in ranks + [one]:
        for case, want in sx_expected(res, cuda).items():
            if res["cases"][case]["launches"] != want:
                failed.append(f"{res['tag']} {case}: launches {res['cases'][case]['launches']}, derived {want}")
        if not res["check_ok"]:
            failed.append(f"{res['tag']} kernels vs plain: {res['check']}")
    keys = ("forward", "backward", "minplus") + SPLIT_ENTRIES
    out["launches"] = {k: sum(p[k] for res in ranks for case in SX_CASES
                              for p in res["cases"][case]["launches"].values()) for k in keys}
    out["cases"] = cases
    out["ranks"] = [{"tag": res["tag"], "s": res["s"], "check": res["check"]} for res in ranks]
    out["one"] = {"check": one["check"]}
    if "pipeline_prep" in prep:
        shutil.rmtree(prep["pipeline_prep"]["root"], ignore_errors=True)
    if failed:
        raise AssertionError("phase 27b (space beside model, expert, stage): " + "; ".join(failed))
    return _finish(prep, out)


def space_axes_phase(device, root: str, **kw) -> dict:
    """Phase 27b alone: ``space_axes_prepare``, four ranks sharing the
    device (gloo), ``space_axes_compare``."""
    prep = space_axes_prepare(device, root, **kw)
    spawn_axes(device, [("space_axes", prep["spec"])], os.path.join(root, "store"))
    return space_axes_compare(device, prep)


def log_space_axes(sx: dict, card: str) -> None:
    log(f"[space_axes] phase 27b: four ranks over gloo on one card, one mesh a case, f32 (TF32 off), vs one "
        f"process: one process {sx['one_s']:.1f} s, ranks {sx['ranks_s']:.1f} s; card {card}")
    for name, c in sx["cases"].items():
        log(f"[space_axes]   {name} over {SX_MESHES[name]}: {json.dumps(c)}; card {card}")
    for r in sx["ranks"] + [dict(sx["one"], tag="one")]:
        log(f"[space_axes]   {r['tag']}: kernels vs plain {json.dumps(r['check'])}")
    log(f"[space_axes] phase 27b took {sx['phase_s']:.1f} s; launches over the four ranks {sx['launches']}; "
        f"card {card}")


# ---- phases 25-27: the rank side in one spawn ---------------------------------
# each phase prepares its data and its one-process run here (``*_prepare``),
# then four ranks spawned once run the phases' rank side in turn, each on its
# own mesh (``spawn_axes``: a fresh process takes seconds to start on the
# card's host), and each phase compares them (``*_compare``)
AXES_WORLD = 4


def _prepare(root: str, spec: dict) -> dict:
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    spec.update(data=os.path.join(root, "data.pt"), ranks_root=os.path.join(root, "ranks"))
    os.makedirs(spec["ranks_root"], exist_ok=True)
    return {"root": root, "spec": spec, "t0": time.perf_counter()}


def _one_process(prep: dict, run, device) -> dict:
    """``run`` in this process (``mesh`` None) with the spec's threads."""
    import torch

    held = torch.get_num_threads()
    torch.set_num_threads(prep["spec"]["threads"])
    try:
        prep["one"] = run(device, os.path.join(prep["root"], "one"), None, prep["spec"])
    finally:
        torch.set_num_threads(held)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    prep["one_s"] = time.perf_counter() - prep["t0"]
    return prep


def _ranks_of(prep: dict, name: str):
    """``(one, ranks, out)``: the one-process result, each rank's, and the
    phase's seconds so far."""
    import torch

    ranks = [torch.load(os.path.join(prep["spec"]["ranks_root"], f"rank{r}.pt"), weights_only=False)
             for r in range(AXES_WORLD)]
    out = {"one_s": prep["one_s"], "ranks_s": max(res["s"] for res in ranks)}
    log(f"[{name}] one process took {out['one_s']:.1f} s, the ranks {out['ranks_s']:.1f} s")
    prep["t_compare"] = time.perf_counter()
    return prep["one"], ranks, out


def _finish(prep: dict, out: dict) -> dict:
    import shutil

    out["phase_s"] = out["one_s"] + out["ranks_s"] + time.perf_counter() - prep["t_compare"]
    shutil.rmtree(prep["root"], ignore_errors=True)
    return out


def _axes_rank(rank: int, world: int, store: str, device: str, jobs: list) -> None:
    """One rank of phases 25-27 (those of ``jobs``, in turn): the process
    group over a ``file://`` store in ``store`` (gloo: the ranks share the
    card), then ``run_axes_jobs``."""
    import datetime

    sys.path.insert(0, REPO)
    import torch

    from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed

    torch.set_num_threads(jobs[0][1].get("threads", 4))
    maybe_initialize_distributed("gloo", f"file://{store}/store", world, rank, device=device,
                                 timeout=datetime.timedelta(seconds=max(AXES_RUNS[n][2] for n, _ in jobs)))
    run_axes_jobs(rank, world, device, jobs)


def run_axes_jobs(rank: int, world: int, device: str, jobs: list) -> None:
    """The rank side of ``jobs`` in this rank of an initialised process
    group of ``world`` ranks: each job's ``data x <axis>`` mesh and run, its
    result (with its seconds) written to the job's ``ranks_root``."""
    import torch

    from multimodal_tta_tpu_torch.parallel.mesh import make_mesh

    for name, spec in jobs:
        run, axis, _ = AXES_RUNS[name]
        devices = [_rank_device(device)] * world
        if isinstance(axis, dict):  # a mesh for each case, every rank alike
            mesh = {case: make_mesh(devices, **sizes) for case, sizes in axis.items()}
        else:
            mesh = make_mesh(devices, data=world // 2, **{axis: 2})
        t0 = time.perf_counter()
        res = run(device, spec["ranks_root"], mesh, spec)
        res["s"] = time.perf_counter() - t0
        torch.save(res, os.path.join(spec["ranks_root"], f"rank{rank}.pt"))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def spawn_axes(device, jobs: list, store: str) -> float:
    """The rank side of ``jobs`` (``[(phase, spec)]``) in ``AXES_WORLD``
    ranks spawned once; returns the seconds."""
    import shutil

    from multimodal_tta_tpu_torch.parallel.distributed import spawn_ranks

    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store, exist_ok=True)
    t0 = time.perf_counter()
    spawn_ranks(_axes_rank, AXES_WORLD, store, (store, str(device), jobs), sum(AXES_RUNS[n][2] for n, _ in jobs))
    return time.perf_counter() - t0


# phase -> (its rank function, the axis beside data=2 (size 2) or each case's mesh, its time limit)
AXES_RUNS = {"model_axis": (tp_run, "model", TP_TIMEOUT_S), "expert_axis": (ep_run, "expert", EP_TIMEOUT_S),
             "stage_axis": (pp_run, "stage", PP_TIMEOUT_S), "space_axes": (sx_run, SX_MESHES, SX_TIMEOUT_S)}


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    # cuBLAS reads its workspace size once, at its first call: fixed here,
    # before any cuBLAS work, so that phase 11's strict step is deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    import numpy as np
    from scipy import ndimage

    from multimodal_tta_tpu_torch.evaluation.seg_eval import (
        SegmentationEvaluationStrategy,
        diag_mm_from_shape,
    )
    from multimodal_tta_tpu_torch.kernels import _build
    from multimodal_tta_tpu_torch.kernels.edt_minplus import (
        addmin_probe,
        edt_cost_matrix,
        minplus,
        minplus_plain,
        squared_edt_volumes,
        squared_edt_volumes_plain,
        volume_plan_for,
    )
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
        fused_instance_norm,
        instance_norm_backward,
        instance_norm_backward_plain,
        instance_norm_forward,
        instance_norm_plain,
        plan_for,
    )
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm, set_plain_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.ops.intensity import make_intensity_normalizer
    from multimodal_tta_tpu_torch.ops.seg_metrics import binary_dice_iou
    from multimodal_tta_tpu_torch.ops.surface import (
        batched_surface_metrics,
        extract_surface,
        squared_edt,
        surface_metrics_single,
    )
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask
    from multimodal_tta_tpu_torch.conf import ConfigNode

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    start_rank_server()  # imports torch and the port in the background, for phases 22-27's ranks
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")

    def sync():
        torch.cuda.synchronize()

    def within(got, ref, tol) -> tuple:
        err = (got.float() - ref.float()).abs()
        bound = tol["atol"] + tol["rtol"] * ref.float().abs()
        return float(err.max()), bool((err <= bound).all())

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("fused_instance_norm", "edt_minplus")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, side by side
        builds = dict(zip(sources, pool.map(_build.load, sources)))
    log(f"[build] nvcc: {_build.nvcc_release()}; {len(sources)} sources in "
        f"{time.perf_counter() - t0:.2f}s")
    for src, built in builds.items():
        log(f"[build] csrc/{src}.cu -> {os.path.relpath(built.path, REPO)} in {built.seconds:.2f}s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    # ---- 2. kernels vs plain ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def norm_inputs(shape, dtype, scale=3.0, shift=1.0):
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)
        g = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.1
        return x, g, b

    def off_kink(x, g, b):
        """Move the few elements whose pre-activation is within 1e-3 of the
        ReLU's kink: there the mask depends on the summation order of the
        statistics, so kernel and plain version may rightly differ."""
        for _ in range(20):  # a moved element shifts its channel's statistics: repeat
            pre = instance_norm_plain(x.float(), g, b, act=None).abs()
            if float(pre.min()) > KINK_MARGIN:
                return x
            x = torch.where(pre < 1e-3, x.float() + 0.25, x.float()).to(x.dtype)
        raise AssertionError("could not move the check's input off the ReLU kink")

    def plan_text(p) -> str:
        if p.regime == "resident":
            return f"resident CG={p.cg} cluster={p.cluster} grid={p.grid} smem={p.smem_bytes}"
        return (f"streaming vec={p.vec} chunks/sample={p.chunks} rows/chunk={p.rows} grid={p.grid} "
                f"second read from {'L2' if p.hbm_reads == 1 else 'HBM'}")

    max_abs_err = 0.0
    d0, h0, w0 = SHAPE[:3]
    level_channels = ((32,), (32, 64), (64, 128), (128, 256), (256, 512))
    path_norm_shapes = [(BATCH, d0 >> lv, h0 >> lv, w0 >> lv, c)
                        for lv, cs in enumerate(level_channels) for c in cs]
    window_norm_shapes = [(WINDOWS, WINDOW_ROI[0] >> lv, WINDOW_ROI[1] >> lv, WINDOW_ROI[2] >> lv, c)
                          for lv, cs in enumerate(level_channels) for c in cs]
    regimes = {}
    for shape in path_norm_shapes + [(1, 3, 5, 7, 48), (2, 3, 5, 7, 7)]:
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            for act in ("relu", None):
                x, g, b = norm_inputs(shape, dtype)
                t1 = time.perf_counter()
                y = fused_instance_norm(x, g, b, act=act)
                sync()
                first = time.perf_counter() - t1
                err, ok = within(y, instance_norm_plain(x, g, b, act=act), tol)
                p = plan_for(x)
                regimes[(shape, dtype)] = p
                log(f"[kernel] {list(shape)} {str(dtype)[6:]} act={act}: {plan_text(p)}; "
                    f"max|kernel-plain|={err:.3g} tol atol={tol['atol']} rtol={tol['rtol']:.3g} "
                    f"first call {first:.3f}s {'ok' if ok else 'FAIL'}")
                if not (ok and y.dtype == dtype and y.shape == x.shape):
                    raise AssertionError(f"kernel disagrees with plain at {shape} {dtype} act={act}")
                max_abs_err = max(max_abs_err, err)
                del x, y
    if {regimes[(s_, torch.bfloat16)].regime for s_ in path_norm_shapes} != {"resident", "streaming"}:
        raise AssertionError("the path's shapes must exercise both regimes")

    # backward: the kernel (through autograd of the wrapper) vs autograd of plain
    backward_err = 0.0
    grad_cases = [(BATCH, 3, 9, 9, 512), (BATCH, 12, 36, 36, 64), (BATCH, 24, 72, 72, 32),
                  (2, 3, 5, 7, 7)]
    for shape in grad_cases:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("relu", None):
                x, g, b = norm_inputs(shape, dtype, scale=1.0, shift=0.0)
                x = off_kink(x, g, b).requires_grad_()
                g.requires_grad_()
                b.requires_grad_()
                gy = torch.randn(shape, generator=gen, device=dev).to(dtype)
                plain_before = instance_norm_backward_plain.cuda_calls
                got = torch.autograd.grad(fused_instance_norm(x, g, b, act=act), (x, g, b), gy)
                no_dx = torch.autograd.grad(fused_instance_norm(x.detach(), g, b, act=act), (g, b), gy)
                sync()
                if instance_norm_backward_plain.cuda_calls != plain_before:
                    raise AssertionError("the wrapper's backward took the plain version on the card")
                ref = torch.autograd.grad(instance_norm_plain(x, g, b, act=act), (x, g, b), gy)
                p = plan_for(x.detach(), backward=True)
                report = []
                for nm, u, v in zip(("dx", "dgamma", "dbeta", "dgamma(no dx)", "dbeta(no dx)"),
                                    got + no_dx, ref + ref[1:]):
                    diff = (u.float() - v.float()).abs()
                    vmax = float(v.float().abs().max())
                    if nm == "dx" and dtype == torch.bfloat16:
                        ok = bool((diff <= DX_BF16_REL * (vmax + v.float().abs())).all())
                        lim = 2 * DX_BF16_REL * vmax
                    else:
                        lim = GRAD_F32_REL * vmax + GRAD_F32_ABS
                        ok = float(diff.max()) <= lim
                    report.append(f"{nm} {float(diff.max()):.3g} (limit {lim:.3g})")
                    if not ok or u.dtype != v.dtype or u.shape != v.shape:
                        raise AssertionError(f"backward {nm} disagrees at {shape} {dtype} act={act}")
                    if nm == "dx":
                        backward_err = max(backward_err, float(diff.max()))
                log(f"[kernel] backward {list(shape)} {str(dtype)[6:]} act={act}: {plan_text(p)}; "
                    f"max err " + ", ".join(report))
                del x, gy, got, ref

    # run to run: the same input twice, outputs and gradients bitwise equal
    for shape in ((BATCH, d0, h0, w0, 32), (BATCH, 12, 36, 36, 128)):
        x, g, b = norm_inputs(shape, torch.bfloat16)
        x.requires_grad_()
        g.requires_grad_()
        b.requires_grad_()
        gy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        runs = []
        for _ in range(2):
            y = fused_instance_norm(x, g, b)
            runs.append((y.detach(),) + torch.autograd.grad(y, (x, g, b), gy))
        sync()
        same = all(torch.equal(u, v) for u, v in zip(*runs))
        log(f"[kernel] {list(shape)} bf16 run twice: y, dx, dgamma, dbeta bitwise equal={same}")
        if not same:
            raise AssertionError(f"the norm kernels are not deterministic at {shape}")
        del x, gy, y, runs

    # the nine norm shapes of the training step at the recipe's batch 8
    # (ReLU on, as in the model): forward and backward kernels against the
    # plain versions on the same statistics; every shape in bf16, the largest
    # (1.02 GB) and the smallest also in f32
    def check_norm_shape(shape, dtype, what: str) -> tuple:
        """Forward and backward kernels (ReLU on) against the plain versions
        on the same statistics at ``shape``: (max |y error|, max |dx error|)."""
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        x, g, b = norm_inputs(shape, dtype, scale=1.0, shift=0.0)
        x = off_kink(x, g, b)
        gy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        y, stats = instance_norm_forward(x, g, b, relu=True)
        err, ok = within(y, instance_norm_plain(x, g, b), tol)
        got = instance_norm_backward(gy, x, g, b, stats, relu=True)
        ref = instance_norm_backward_plain(gy, x, g, b, stats[0], stats[1], True)
        sync()
        report = []
        for nm, u, v in zip(("dx", "dgamma", "dbeta"), got, ref):
            diff = (u.float() - v.float()).abs()
            vmax = float(v.float().abs().max())
            if nm == "dx" and dtype == torch.bfloat16:
                good = bool((diff <= DX_BF16_REL * (vmax + v.float().abs())).all())
            else:
                good = float(diff.max()) <= GRAD_F32_REL * vmax + GRAD_F32_ABS
            report.append(f"{nm} {float(diff.max()):.3g}")
            ok = ok and good and u.dtype == v.dtype and u.shape == v.shape
        pf, pb = plan_for(x), plan_for(x, backward=True)
        log(f"[kernel] {what} shape {list(shape)} {str(dtype)[6:]} relu ({x.numel() * x.element_size() / 1e6:.1f} MB): "
            f"forward {plan_text(pf)}; backward {plan_text(pb)}; max|kernel-plain| y {err:.3g}, "
            + ", ".join(report) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the norm kernels disagree with plain at the {what} shape {shape} {dtype}")
        return err, float((got[0].float() - ref[0].float()).abs().max()), pf, pb

    train_norm_shapes = [(TRAIN_BATCH,) + s[1:] for s in path_norm_shapes]
    for shape, dtype in ([(s, torch.bfloat16) for s in train_norm_shapes]
                         + [(train_norm_shapes[0], torch.float32), (train_norm_shapes[-1], torch.float32)]):
        err, dx_err, *_ = check_norm_shape(shape, dtype, "training")
        max_abs_err, backward_err = max(max_abs_err, err), max(backward_err, dx_err)
    # the norm shapes of windowed Tent (phase 15): the stock 4 windows of
    # [32,96,96] down the levels, bf16
    for shape in window_norm_shapes:
        err, dx_err, *_ = check_norm_shape(shape, torch.bfloat16, "window")
        max_abs_err, backward_err = max(max_abs_err, err), max(backward_err, dx_err)

    # ---- 3. full-width forward ------------------------------------------
    instance_norm_backward_plain.cuda_calls = 0  # phases 3-5 must leave it at 0
    backward_launches = {}
    t1 = time.perf_counter()
    model = UNet3D(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512),
                   strides=(2, 2, 2, 2), num_res_units=2, dtype=torch.bfloat16,
                   device=dev, seed=0)
    n_params = len(list(model.parameters()))
    n_norm = sum(norm_param_mask(model).values())
    log(f"[forward] UNet3D 32..512 bf16: {n_params} param tensors, {n_norm} norm, "
        f"{sum(p.numel() for p in model.parameters())} params; built in {time.perf_counter() - t1:.1f}s")
    if (n_params, n_norm) != (82, 36):
        raise AssertionError("flagship must have 82 param tensors, 36 of them norm affines")
    norm_fn = make_intensity_normalizer(
        normalize=True, intensity_policy=HECKTOR_POLICY, channel_names=["ct", "pt"])
    data = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn((BATCH,) + SHAPE, generator=data, device=dev) * 100 for _ in range(5)]

    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kw: shapes.append((tuple(args[0].permute(0, 2, 3, 4, 1).shape), kw["relu"])),
        with_kwargs=True) for m in model.modules() if isinstance(m, InstanceNorm)]
    launches = {}
    with torch.no_grad():
        xn = norm_fn(batches[0])
        sync()
        fused_instance_norm.launches = 0
        logits = model(xn)
        sync()
        launches["forward"] = fused_instance_norm.launches
        for h in hooks:
            h.remove()
        set_plain_norm(model, True)
        logits_plain = model(xn)
        fwd_plain_ms = cuda_ms(lambda: model(xn), iters=3, warmup=1)
        set_plain_norm(model, False)
        fwd_ms = cuda_ms(lambda: model(xn), iters=3, warmup=1)
    expect = (BATCH,) + SHAPE[:3] + (1,)
    rel = float((logits - logits_plain).norm() / logits_plain.norm())
    log(f"[forward] logits {list(logits.shape)} {logits.dtype}, finite={bool(torch.isfinite(logits).all())}; "
        f"{launches['forward']} kernel launches per forward ({len(shapes)} norm layers); "
        f"kernel vs plain norm: rel L2 {rel:.3g} (limit {LOGITS_REL_L2}), max abs "
        f"{float((logits - logits_plain).abs().max()):.3g}; forward {fwd_ms:.2f} ms "
        f"(plain norm {fwd_plain_ms:.2f} ms)")
    if tuple(logits.shape) != expect or not torch.isfinite(logits).all():
        raise AssertionError("forward logits have the wrong shape or are not finite")
    if launches["forward"] != len(shapes) or len(shapes) != 18:
        raise AssertionError(f"expected 18 kernel launches per forward, got {launches['forward']}")
    if not rel <= LOGITS_REL_L2:
        raise AssertionError("forward through the kernel disagrees with the plain norm")
    del logits, logits_plain, xn

    # ---- 4. serving -------------------------------------------------------
    names = [n for n, v in norm_param_mask(model).items() if v]
    source = {n: p.detach().clone() for n, p in model.named_parameters() if n in names}
    serving = {}
    for proto, predict, episodic, n_batches in (
        ("online", "inline", False, 8), ("strict", "post", True, 6),
    ):
        cfg = ConfigNode({
            "task": {"seed": 0},
            "training": {"criterion": {"sigmoid": True}},
            "tta": {"method": "tent", "steps": 1, "lr": 1e-3, "optimizer": "sgd",
                    "momentum": 0.9, "update": "norm", "episodic": episodic},
        })
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in source:
                    p.copy_(source[n])
        adapter = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        step = adapter.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode=predict)
        times, ents = [], []
        sync()
        fused_instance_norm.launches = 0
        fused_instance_norm.backward_launches = 0
        for i in range(n_batches):
            t1 = time.perf_counter()
            state, pred = step(model, batches[i % len(batches)], BATCH)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
            ents.append(adapter.last_entropy)
        launches[proto] = fused_instance_norm.launches
        backward_launches[proto] = fused_instance_norm.backward_launches
        params = dict(model.named_parameters())
        moved = [n for n in names if bool((params[n] - source[n]).abs().max() > 0)]
        # every norm tensor must get a gradient; a scale at 1.0 stays put when
        # each update is below half an f32 ulp there (lr * |g| < 6e-8)
        reached = [n for n in names if params[n].grad is not None
                   and bool(params[n].grad.abs().max() > 0) and bool(torch.isfinite(params[n].grad).all())]
        still = {n: float(params[n].grad.abs().max()) * 1e-3 for n in names if n not in moved}
        steady = times[len(times) // 2:]  # the first steps still warm the allocator up
        ms = sum(steady) / len(steady)
        serving[proto] = {"ms_per_step": times, "steady_ms": ms, "volumes_per_s": BATCH * 1e3 / ms,
                          "entropy": ents, "launches": launches[proto],
                          "backward_launches": backward_launches[proto], "grad_reached": len(reached),
                          "moved": len(moved)}
        log(f"[serving] {proto} ({'episodic' if episodic else 'continual'}, predict={predict}) "
            f"batch {BATCH}: ms/step {[round(t, 2) for t in times]} -> steady (mean of the later half) {ms:.2f} ms, "
            f"{BATCH * 1e3 / ms:.2f} volumes/s; entropy {ents}; nonzero gradient in "
            f"{len(reached)}/{len(names)} norm tensors, {len(moved)} moved; pred {list(pred.shape)} "
            f"{pred.dtype}; {launches[proto]} forward kernel launches ({launches[proto] // n_batches}/step), "
            f"{backward_launches[proto]} backward kernel launches "
            f"({backward_launches[proto] // n_batches}/step); card {smi}")
        if still:
            log(f"[serving] {proto}: not moved (max lr*|grad| of the last step, f32 half-ulp at 1.0 "
                f"is 5.96e-08): {still}")
        if not all(e == e and abs(e) != float("inf") for e in ents):
            raise AssertionError(f"{proto}: entropy not finite")
        if len(reached) != 36 or len(names) != 36:
            raise AssertionError(f"{proto}: gradient reached {len(reached)} of 36 norm tensors")
        if any(not n.endswith(".scale") for n in still):
            raise AssertionError(f"{proto}: norm biases did not move: {sorted(still)}")
        if pred.dtype != torch.uint8 or tuple(pred.shape) != expect:
            raise AssertionError(f"{proto}: predictions {pred.dtype} {tuple(pred.shape)}")
        per_step = 18 if predict == "inline" else 36
        if launches[proto] != per_step * n_batches:
            raise AssertionError(f"{proto}: {launches[proto]} launches, expected {per_step * n_batches}")
        if backward_launches[proto] != 18 * n_batches:
            raise AssertionError(f"{proto}: {backward_launches[proto]} backward launches, expected "
                                 f"{18 * n_batches} (one per norm per Tent step)")
    del model, state, pred, batches

    # ---- 5. small-input parity: kernel vs plain norm through one Tent step -
    small = torch.randn((1, 16, 32, 32, 2), generator=data, device=dev) * 100
    out = {}
    for plain in (False, True):
        m = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.float32, device=dev, seed=3)
        set_plain_norm(m, plain)
        cfg = ConfigNode({"tta": {"steps": 1, "lr": 1e-3, "momentum": 0.9, "episodic": True}})
        src = {n: p.detach().clone() for n, p in m.named_parameters()}
        ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        _, pred = ad.make_adapt_predict_fn(m, threshold=THRESHOLD, predict_mode="post")(m, small, 1)
        delta = torch.cat([(p - src[n]).flatten() for n, p in m.named_parameters() if p.requires_grad])
        out[plain] = (ad.last_entropy, delta, pred)
        del m
    (e_k, d_k, p_k), (e_p, d_p, p_p) = out[False], out[True]
    ent_rel = abs(e_k - e_p) / abs(e_p)
    d_rel = float((d_k - d_p).norm() / d_p.norm())
    agree = float((p_k == p_p).float().mean())
    log(f"[parity] f32 Tent step [1,16,32,32,2], kernel vs plain norm: entropy rel {ent_rel:.3g} "
        f"(limit 1e-4), norm-delta rel {d_rel:.3g} (limit 1e-3), predictions agree {agree:.6f} "
        f"(limit 0.999)")
    if not (ent_rel <= 1e-4 and d_rel <= 1e-3 and agree >= 0.999):
        raise AssertionError("Tent step through the kernel disagrees with the plain norm")
    if instance_norm_backward_plain.cuda_calls != 0:
        raise AssertionError(f"phases 3-5 called the plain norm backward on the card "
                             f"{instance_norm_backward_plain.cuda_calls} times")

    # ---- 6. kernel timing at every norm shape of one forward --------------
    import torch.nn.functional as F

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bytes", "flops")

    def time_norm_calls(calls: dict) -> tuple:
        """The forward and the backward kernel at each ``(shape, relu)`` of
        ``calls`` (bf16) against the plain versions, the library call and
        the byte bound, times the number of calls: (forward, backward)
        totals, each with its bound."""
        nonlocal max_abs_err, backward_err
        totals, btotals = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
        for (shape, relu), n in calls.items():
            c = shape[-1]
            act = "relu" if relu else None
            x, g, b = norm_inputs(shape, torch.bfloat16)
            x = off_kink(x, g, b) if relu else x
            ref = instance_norm_plain(x, g, b, act=act)
            err, ok = within(fused_instance_norm(x, g, b, act=act), ref, TOL_BF16)
            if not ok:
                raise AssertionError(f"kernel disagrees with plain at {shape}")
            max_abs_err = max(max_abs_err, err)
            del ref
            ms_a = cuda_ms(lambda: fused_instance_norm(x, g, b, act=act))
            ms_b = cuda_ms(lambda: fused_instance_norm(x, g, b, act=act))
            ms = min(ms_a, ms_b)
            plain_ms = cuda_ms(lambda: instance_norm_plain(x, g, b, act=act))
            x_ncdhw = x.permute(0, 4, 1, 2, 3)

            def library(xx=x_ncdhw, gg=g, bb=b):
                out = F.instance_norm(xx, weight=gg, bias=bb, eps=1e-5)
                return F.relu(out) if relu else out

            lib_ms = cuda_ms(library)
            nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4  # read x, write y, gamma, beta
            flops = 8 * x.numel()  # stats: add, mul, add; normalize, affine, relu: 5
            log(f"[timing] forward {list(shape)} bf16 relu={relu} x{n} ({plan_for(x).regime}): "
                f"kernel {ms:.4f} ms ({ms_a:.4f}, {ms_b:.4f}), plain {plain_ms:.4f} ms, "
                f"F.instance_norm(+relu) {lib_ms:.4f} ms, "
                f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, max err {err:.3g}")
            for key, v in zip(keys, (ms, plain_ms, lib_ms, nbytes, flops)):
                totals[key] += n * v

            # backward of the same call: the kernel's wrapper, the plain backward,
            # autograd of the library call (its time includes the autograd engine)
            gy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            gr, br = g.detach().requires_grad_(), b.detach().requires_grad_()
            stats = instance_norm_forward(x, g, b, relu=relu)[1]
            got = instance_norm_backward(gy, x, g, b, stats, relu=relu)
            ref = instance_norm_backward_plain(gy, x, g, b, stats[0], stats[1], relu)
            for nm, u, v in zip(("dx", "dgamma", "dbeta"), got, ref):
                diff = (u.float() - v.float()).abs()
                vmax = float(v.float().abs().max())
                ok = (bool((diff <= DX_BF16_REL * (vmax + v.float().abs())).all()) if nm == "dx"
                      else float(diff.max()) <= GRAD_F32_REL * vmax + GRAD_F32_ABS)
                if not ok:
                    raise AssertionError(f"backward {nm} disagrees with the plain backward at {shape}")
            backward_err = max(backward_err, float((got[0].float() - ref[0].float()).abs().max()))
            del got, ref
            bms = min(cuda_ms(lambda: instance_norm_backward(gy, x, g, b, stats, relu=relu)) for _ in range(2))
            bplain_ms = cuda_ms(lambda: instance_norm_backward_plain(gy, x, g, b, stats[0], stats[1], relu),
                                iters=5)
            xl = x_ncdhw.detach().requires_grad_()
            yl = library(xl, gr, br)
            gyl = gy.permute(0, 4, 1, 2, 3)
            blib_ms = cuda_ms(lambda: torch.autograd.grad(yl, (xl, gr, br), gyl, retain_graph=True), iters=5)
            bbytes = 3 * x.numel() * x.element_size() + 2 * c * 4 * (2 + 2 * shape[0])  # gy, x, dx; params, stats, sums
            bflops = 14 * x.numel()
            log(f"[timing] backward {list(shape)} bf16 relu={relu} x{n} "
                f"({plan_for(x, backward=True).regime}): kernel {bms:.4f} ms, plain {bplain_ms:.4f} ms, "
                f"autograd of F.instance_norm(+relu) {blib_ms:.4f} ms, bound {bbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
            for key, v in zip(keys, (bms, bplain_ms, blib_ms, bbytes, bflops)):
                btotals[key] += n * v
            del x, gy, stats, xl, yl, gyl, x_ncdhw, library  # library's defaults hold x
        for tot in (totals, btotals):
            t_bytes, t_ops = tot["bytes"] / HBM_BYTES_PER_S * 1e3, tot["flops"] / FP32_FLOPS * 1e3
            tot["bound_ms"], tot["bound_by"] = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        return totals, btotals

    # one forward's norm calls at the serving batch, then at the training
    # recipe's batch (one training step's 18 forward and 18 backward calls)
    norm_totals = {}
    for batch in (BATCH, TRAIN_BATCH):
        totals, btotals = time_norm_calls({((batch,) + shape[1:], relu): n for (shape, relu), n in counts.items()})
        norm_totals[batch] = (totals, btotals)
        log(f"[timing] one forward's {len(shapes)} norm calls, bf16 batch {batch}: forward kernel "
            f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, library {totals['library_ms']:.4f} ms, "
            f"bound {totals['bound_ms']:.4f} ms; backward kernel {btotals['ms']:.4f} ms, plain "
            f"{btotals['plain_ms']:.4f} ms, library {btotals['library_ms']:.4f} ms, bound "
            f"{btotals['bound_ms']:.4f} ms; card {smi}")
    totals, btotals = norm_totals[BATCH]
    # ---- 7. min-plus kernel vs plain --------------------------------------
    def cost_matrix(n: int, spacing: float):
        return edt_cost_matrix(n, spacing, device=dev)

    def sparse_lines(rows: int, n: int, keep: float = 0.85):
        """Lines of 0 / +inf as the EDT's first pass sees them."""
        return torch.where(torch.rand(rows, n, generator=gen, device=dev) > keep, 0.0,
                           float("inf")).to(torch.float32)

    d_, h_, w_ = SHAPE[:3]
    # the line shapes of one volume's three passes: (rows, n, spacing)
    path_shapes = sorted({(h_ * w_, d_, SPACING[0]), (d_ * w_, h_, SPACING[1]), (d_ * h_, w_, SPACING[2])})
    cases = [(r, n, sp, sparse_lines(r, n)) for (r, n, sp) in path_shapes]
    cases += [(r, n, 1.5, sparse_lines(r, n)) for r, n in ((10, 48), (300, 144), (256, 128), (1, 7))]
    cases.append((4, 16, 1.0, torch.full((4, 16), float("inf"), device=dev)))
    cases.append((20, 32, 3.0, torch.rand(20, 32, generator=gen, device=dev) * 50))
    minplus_err = 0.0
    for rows, n, sp, f in cases:
        c = cost_matrix(n, sp)
        got = minplus(f, c)
        sync()
        ref = minplus_plain(f, c)
        equal = torch.equal(got, ref)
        nan = bool(torch.isnan(got).any())
        finite = torch.isfinite(ref)
        err = float((got[finite] - ref[finite]).abs().max()) if bool(finite.any()) else 0.0
        minplus_err = max(minplus_err, err)
        log(f"[min-plus] f [{rows},{n}] spacing {sp}: bitwise equal to plain={equal}, "
            f"inf out {int(torch.isinf(got).sum())} (plain {int(torch.isinf(ref).sum())}), nan={nan}, "
            f"max abs err {err:.3g} (tolerance 0: same adds, min is exact in any order)")
        if not equal or nan:
            raise AssertionError(f"min-plus kernel disagrees with plain at [{rows},{n}]")
    if not bool(torch.isinf(minplus(cases[-2][3], cost_matrix(16, 1.0))).all()):
        raise AssertionError("min-plus: an all-inf input must stay all inf")

    def sparse_points(shape, keep: float):
        return torch.rand(shape, generator=gen, device=dev) > keep

    pts4 = sparse_points((2 * BATCH, d_, h_, w_), 0.999)
    pts4[1] = False  # one volume without points among the four
    pts8 = sparse_points((2 * 4, d_, h_, w_), 0.999)  # a training validation batch: 4 volumes, 1 region
    pts8[5] = False
    volume_cases = [("1 volume", pts4[:1].contiguous()), ("4 volumes, one empty", pts4),
                    ("8 volumes, one empty", pts8),
                    ("ragged [5,7,13]", sparse_points((3, 5, 7, 13), 0.9)),
                    ("ragged [20,31,155]", sparse_points((2, 20, 31, 155), 0.99)),
                    ("all empty", torch.zeros((2, 6, 10, 12), dtype=torch.bool, device=dev)),
                    ("all set", torch.ones((2, 6, 10, 12), dtype=torch.bool, device=dev))]
    for label_, pts in volume_cases:
        for sp in (SPACING, (0.5, 2.0, 1.25)):
            for root in (False, True):
                before = minplus.launches
                got = squared_edt_volumes(pts, sp, sqrt=root)
                sync()
                n_launch = minplus.launches - before
                ref = squared_edt_volumes_plain(pts, sp, sqrt=root)
                again = squared_edt_volumes(pts, sp, sqrt=root)
                equal, same = torch.equal(got, ref), torch.equal(got, again)
                nan = bool(torch.isnan(got).any())
                finite = torch.isfinite(ref)
                err = float((got[finite] - ref[finite]).abs().max()) if bool(finite.any()) else 0.0
                minplus_err = max(minplus_err, err)
                log(f"[min-plus] squared_edt_volumes {list(pts.shape)} ({label_}) spacing {sp} sqrt={root}: "
                    f"{n_launch} launch, bitwise equal to plain={equal}, run twice equal={same}, inf out "
                    f"{int(torch.isinf(got).sum())} (plain {int(torch.isinf(ref).sum())}), nan={nan}")
                if not (equal and same) or nan or n_launch != 1:
                    raise AssertionError(f"squared_edt_volumes disagrees with plain at {label_} {sp} sqrt={root}")
    vp = volume_plan_for(pts4)
    log(f"[min-plus] plan of {list(pts4.shape)}: {vp.threads} threads, {vp.smem_bytes} bytes of shared memory; "
        + "; ".join(f"n={q.n} {q.kind} rows/tile={q.rows} tiles={q.tiles}" for q in vp.passes))
    del pts4, pts8, volume_cases

    # ---- 8. squared EDT through the kernel vs scipy -----------------------
    rng = np.random.RandomState(7)
    zz, yy, xx = np.meshgrid(np.arange(d_), np.arange(h_), np.arange(w_), indexing="ij")

    def ellipsoid(center, radii):
        return (((zz - center[0]) / radii[0]) ** 2 + ((yy - center[1]) / radii[1]) ** 2
                + ((xx - center[2]) / radii[2]) ** 2) <= 1.0

    body = ellipsoid((24, 70, 80), (9, 30, 22))
    points_np = (body & ~ndimage.binary_erosion(body)) | (rng.rand(d_, h_, w_) > 0.9999)
    t1 = time.perf_counter()
    edt_ref = ndimage.distance_transform_edt(~points_np, sampling=SPACING) ** 2
    scipy_s = time.perf_counter() - t1
    points = torch.from_numpy(points_np).to(dev)
    before = minplus.launches
    edt = squared_edt(points, SPACING)
    sync()
    edt_launches = minplus.launches - before
    rel = float(np.max(np.abs(edt.cpu().numpy() - edt_ref) / np.maximum(edt_ref, 1.0)))
    empty = squared_edt(torch.zeros_like(points), SPACING)
    log(f"[EDT] squared_edt {list(points.shape)} spacing {SPACING}, {int(points_np.sum())} points: "
        f"{edt_launches} kernel launches, max rel err vs scipy {rel:.3g} (limit {EDT_REL_TOL}); "
        f"empty mask all inf={bool(torch.isinf(empty).all())}; scipy on the host {scipy_s * 1e3:.1f} ms")
    if edt_launches != 1 or not rel <= EDT_REL_TOL or not bool(torch.isinf(empty).all()):
        raise AssertionError("squared EDT through the kernel disagrees with scipy")
    if not edt.is_contiguous() or edt.shape != points.shape:
        raise AssertionError("squared EDT must return a contiguous [D,H,W] tensor")

    # ---- 9. evaluation under adaptation ------------------------------------
    model = UNet3D(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512),
                   strides=(2, 2, 2, 2), num_res_units=2, dtype=torch.bfloat16,
                   device=dev, seed=0)
    source_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loader = []
    for doms in DOMAINS:
        label = np.stack([
            ellipsoid(rng.uniform((16, 50, 50), (32, 94, 94)), rng.uniform((4, 10, 10), (10, 30, 30)))
            for _ in range(BATCH)])[..., None].astype(np.float32)
        loader.append({"image": (rng.randn(BATCH, *SHAPE) * 100).astype(np.float32),
                       "label": label, "domain": doms})
    diag = diag_mm_from_shape(d_, h_, w_, SPACING)
    per_dom = ("gtvt_dc", "avg_dc", "miou", "gtvt_hd95", "avg_hd95", "gtvt_asd", "avg_asd",
               "gtvt_nsd", "avg_nsd")
    schema = set(per_dom) | {"jc", "loss"} | {f"dom/{d}/{k}" for d in ("CHUM", "CHGJ") for k in per_dom}

    def check_metrics(tag: str, m: dict) -> None:
        if set(m) != schema:
            raise AssertionError(f"{tag}: keys differ from the schema: {sorted(set(m) ^ schema)}")
        for k, v in m.items():
            base = k.rsplit("/", 1)[-1]
            hi = diag if base.endswith(("_hd95", "_asd")) else (float("inf") if base == "loss" else 1.0)
            if not (v == v and 0.0 <= v <= hi * (1 + 1e-6)):
                raise AssertionError(f"{tag}: {k}={v} outside [0, {hi}]")

    def unchanged(tag: str) -> None:
        for k, v in model.state_dict().items():
            if not torch.equal(v, source_sd[k]):
                raise AssertionError(f"{tag}: evaluate left {k} changed")

    def max_diff(a: dict, b: dict) -> float:
        return max(abs(a[k] - b[k]) for k in a)

    def make_engine(method: str, episodic: bool, threshold: float = THRESHOLD) -> TTAEngine:
        return TTAEngine(ConfigNode(eval_config(method, episodic, threshold)),
                         device_transform=DEVICE_TRANSFORM, device=dev)

    eval_modes = (("eval_none", "none", True), ("eval_tent_episodic", "tent", True),
                  ("eval_tent_continual", "tent", False))
    eval_runs, eval_launches, norm_eval_launches, eval_ms = {}, {}, {}, {}
    instance_norm_backward_plain.cuda_calls = 0  # the evaluation runs must leave it at 0
    for tag, method, episodic in eval_modes:
        engine = make_engine(method, episodic)
        sync()
        minplus.launches = 0
        fused_instance_norm.launches = 0
        fused_instance_norm.backward_launches = 0
        t1 = time.perf_counter()
        m = engine.evaluate(model, loader)
        sync()
        eval_ms[tag] = (time.perf_counter() - t1) * 1e3 / len(loader)
        eval_launches[tag] = minplus.launches
        norm_eval_launches[tag] = fused_instance_norm.launches
        backward_launches[tag] = fused_instance_norm.backward_launches
        eval_runs[tag] = m
        check_metrics(tag, m)
        unchanged(tag)
        log(f"[eval] {tag}: {len(loader)} batches of {BATCH}, {eval_ms[tag]:.1f} ms/batch (host clock, "
            f"H2D and first-call warm-up included); gtvt_dc {m['gtvt_dc']:.6f} miou {m['miou']:.6f} "
            f"loss {m['loss']:.5f} hd95 {m['gtvt_hd95']:.4f} asd {m['gtvt_asd']:.4f} nsd {m['gtvt_nsd']:.6f}; "
            f"dom/CHUM dc {m['dom/CHUM/gtvt_dc']:.6f} dom/CHGJ dc {m['dom/CHGJ/gtvt_dc']:.6f}; "
            f"min-plus launches {eval_launches[tag]} ({eval_launches[tag] // len(loader)}/batch), "
            f"norm launches {norm_eval_launches[tag]} forward, {backward_launches[tag]} backward; card {smi}")
        if eval_launches[tag] != len(loader):  # all surfaces and axes of a batch in one launch
            raise AssertionError(f"{tag}: {eval_launches[tag]} min-plus launches, expected {len(loader)}")
        per_batch_norm = 18 if method == "none" else 36
        if norm_eval_launches[tag] != per_batch_norm * len(loader):
            raise AssertionError(f"{tag}: {norm_eval_launches[tag]} norm launches")
        if backward_launches[tag] != (0 if method == "none" else 18 * len(loader)):
            raise AssertionError(f"{tag}: {backward_launches[tag]} norm backward launches")
    if instance_norm_backward_plain.cuda_calls != 0:
        raise AssertionError(f"the evaluation runs called the plain norm backward on the card "
                             f"{instance_norm_backward_plain.cuda_calls} times")

    # checks beside the main path (their launches are not reported)
    strategy = SegmentationEvaluationStrategy(ConfigNode(eval_config("none", True)))
    dice_host = []
    with torch.no_grad():
        for b in loader:
            _, prob = strategy._probs_fn(model)(torch.from_numpy(b["image"]).to(dev))
            p = (prob >= THRESHOLD).cpu().numpy().astype(np.float64).reshape(BATCH, -1)
            g = (b["label"] > 0.5).astype(np.float64).reshape(BATCH, -1)
            dice_host += list((2 * (p * g).sum(1) + 1e-7) / (p.sum(1) + g.sum(1) + 1e-7))
    dice_diff = abs(float(np.mean(dice_host)) - eval_runs["eval_none"]["gtvt_dc"])
    again = make_engine("tent", True).evaluate(model, loader)
    unchanged("second episodic evaluate")
    none_again = make_engine("none", True).evaluate(model, loader)
    d_again = max_diff(again, eval_runs["eval_tent_episodic"])
    d_none = max_diff(none_again, eval_runs["eval_none"])
    log(f"[eval] Dice of the none run vs numpy on the host from the same predictions: diff {dice_diff:.3g} "
        f"(limit {DICE_ABS_TOL}); a second episodic evaluate: max diff {d_again:.3g}; a none run after the "
        f"Tent runs vs the first: max diff {d_none:.3g} (limit 1e-6 each; the model's tensors are bitwise "
        f"the source's after every run)")
    if not (dice_diff <= DICE_ABS_TOL and d_again <= 1e-6 and d_none <= 1e-6):
        raise AssertionError("evaluation is not repeatable or disagrees with the host recomputation")
    zero = make_engine("none", True, threshold=1.5).evaluate(model, loader[:1])
    log(f"[eval] all-empty prediction (threshold 1.5): hd95 {zero['gtvt_hd95']:.4f} asd {zero['gtvt_asd']:.4f} "
        f"(volume diagonal {diag:.4f}), nsd {zero['gtvt_nsd']}, dc {zero['gtvt_dc']:.3g}")
    if not (abs(zero["gtvt_hd95"] - diag) <= 1e-4 and abs(zero["gtvt_asd"] - diag) <= 1e-4
            and zero["gtvt_nsd"] == 0.0 and zero["gtvt_dc"] < 1e-6):
        raise AssertionError("an empty prediction must get the diagonal penalty and NSD 0")
    # all pairs at once against the one-pair function: a predicted and a label
    # surface per sample, plus an empty prediction and an empty label
    with torch.no_grad():
        b0 = loader[0]
        _, prob = strategy._probs_fn(model)(torch.from_numpy(b0["image"]).to(dev))
    pair_pred = torch.cat([(prob >= THRESHOLD).float(), torch.zeros_like(prob[:1]), (prob[:1] >= THRESHOLD).float()])
    lab = torch.from_numpy(b0["label"]).to(dev)
    pair_gt = torch.cat([lab, lab[:1], torch.zeros_like(lab[:1])])
    for symmetric in (False, True):
        whole = batched_surface_metrics(pair_pred, pair_gt, spacing=SPACING, symmetric_asd=symmetric,
                                        nsd_tol=NSD_TOL)
        worst = 0.0
        for i in range(pair_pred.shape[0]):
            one = surface_metrics_single(pair_pred[i, ..., 0], pair_gt[i, ..., 0], SPACING,
                                         symmetric_asd=symmetric, nsd_tol=NSD_TOL)
            hd, asd, nsd = (float(x[i, 0]) for x in whole)
            hd1, asd1, nsd1 = (float(x) for x in one)
            if asd1 != float("inf"):
                worst = max(worst, abs(asd - asd1) / max(asd1, 1e-30))
            if not (hd == hd1 and nsd == nsd1 and (asd == asd1 or abs(asd - asd1) <= ASD_REL_TOL * asd1)):
                raise AssertionError(f"batched surface metrics differ from the one-pair function at pair {i}: "
                                     f"{(hd, asd, nsd)} vs {(hd1, asd1, nsd1)}")
        log(f"[eval] batched_surface_metrics vs surface_metrics_single, {pair_pred.shape[0]} pairs (two of them "
            f"one-sided empty), symmetric_asd={symmetric}: HD95 and NSD equal, ASD max rel diff {worst:.3g} "
            f"(limit {ASD_REL_TOL:.3g}); hd95 {[round(float(v), 4) for v in whole[0][:, 0]]} "
            f"asd {[round(float(v), 4) for v in whole[1][:, 0]]}")
    del pair_pred, pair_gt, lab, prob

    # ---- 10. timing: the distance transform and one evaluated batch --------
    image = torch.from_numpy(loader[0]["image"]).to(dev)
    label = torch.from_numpy(loader[0]["label"]).to(dev)
    with torch.no_grad():
        logits, prob = strategy._probs_fn(model)(image)
    pred = (prob >= THRESHOLD).to(torch.float32)
    gt = (label > 0.5).to(torch.float32)
    # the 2 * BATCH surfaces whose transform one evaluated batch launches
    surfaces = extract_surface(torch.cat([gt[..., 0], pred[..., 0]]) > 0.5)
    n_vol = surfaces.shape[0]
    edt_ms = min(cuda_ms(lambda: squared_edt_volumes(surfaces, SPACING, sqrt=True)) for _ in range(3))
    edt_plain_ms = cuda_ms(lambda: squared_edt_volumes_plain(surfaces, SPACING, sqrt=True), iters=3, warmup=1)
    edt_ops = 2 * surfaces.numel() * (d_ + h_ + w_)  # an add and a min per (voxel, j), three passes
    edt_bytes = surfaces.numel() * (1 + 4)  # the byte mask read once, the f32 field written once
    t_o, t_b = edt_ops / FP32_ADDMIN_OPS * 1e3, edt_bytes / HBM_BYTES_PER_S * 1e3
    probe = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in (0, 1):
        ops = addmin_probe(dev, 8 * n_sm, 4096, mode)
        probe[mode] = ops / min(cuda_ms(lambda: addmin_probe(dev, 8 * n_sm, 4096, mode), iters=5)
                                for _ in range(3)) / 1e9
    log(f"[timing] squared_edt_volumes of one evaluated batch ({n_vol} surfaces {[d_, h_, w_]}, root written, one "
        f"launch): kernel {edt_ms:.4f} ms, plain {edt_plain_ms:.3f} ms, bound {max(t_o, t_b):.5f} ms "
        f"({'operations' if t_o >= t_b else 'bytes'}: operations {t_o:.5f} at the data sheet's "
        f"{FP32_ADDMIN_OPS / 1e12:.1f} T add-or-min/s, bytes {t_b:.5f}); the register-only probe reaches "
        f"{probe[1]:.2f} T add-or-min/s with two f32 adds + one three-input integer min per link, this kernel's "
        f"inner loop (bound at that rate {edt_ops / probe[1] / 1e9:.5f} ms), and {probe[0]:.2f} T/s with one f32 "
        f"add + one f32 min, the general entry's; no single PyTorch call computes a (min,+) product: library "
        f"null; card {smi}")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[timing] SM clock right after the probe, and its maximum: {clocks}; the first min-plus kernel "
        f"(12 launches per evaluated batch) took 0.403 ms for this work: from PERF.md, not measured here")
    general = {}
    for rows, n, sp in path_shapes:
        f = sparse_lines(rows, n, keep=0.99)
        c = cost_matrix(n, sp)
        general[f"[{rows},{n}]"] = {
            "ms": min(cuda_ms(lambda: minplus(f, c)) for _ in range(2)),
            "plain_ms": cuda_ms(lambda: minplus_plain(f, c), iters=5),
            "bound_ms": max(2 * rows * n * n / FP32_ADDMIN_OPS, 4 * (2 * rows * n + n * n) / HBM_BYTES_PER_S) * 1e3}
    log("[timing] minplus(f, cost), the general entry (off the evaluation path), per call: "
        + "; ".join(f"f {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.5f} ms"
                    for k, v in general.items()) + f"; card {smi}")

    with torch.no_grad():
        stacked = torch.cat([gt[..., 0], pred[..., 0]]) > 0.5
        dist = squared_edt_volumes(surfaces, SPACING, sqrt=True).reshape(n_vol, -1)
        masked = torch.where(surfaces.reshape(n_vol, -1), dist, float("inf"))
        split = {
            "forward": cuda_ms(lambda: strategy._probs_fn(model)(image), iters=5),
            "dice_iou": cuda_ms(lambda: binary_dice_iou(pred, gt), iters=5),
            "loss": cuda_ms(lambda: [strategy.loss_fn(logits[i:i + 1], label[i:i + 1])
                                     for i in range(BATCH)], iters=5),
            "surface": cuda_ms(lambda: batched_surface_metrics(
                pred, gt, spacing=SPACING, nsd_tol=NSD_TOL), iters=5),
            "eval_step": cuda_ms(lambda: strategy._eval_step(model, image, label), iters=5),
            "surface/edt_1_launch": edt_ms,
            "surface/sort_1": cuda_ms(lambda: torch.sort(masked, dim=-1)),
            "surface/extract_surface_1": cuda_ms(lambda: extract_surface(stacked)),
        }
    log(f"[timing] one evaluated batch of {BATCH} volumes, 1 region (ms, CUDA events around each part "
        f"run alone): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; card {smi}")
    eval_warm_ms = {}
    for tag, method, episodic in eval_modes:  # the same runs again, warm: host clock, H2D included
        engine = make_engine(method, episodic)
        sync()
        t1 = time.perf_counter()
        engine.evaluate(model, loader)
        sync()
        eval_warm_ms[tag] = (time.perf_counter() - t1) * 1e3 / len(loader)
    log("[timing] evaluate() repeated warm, ms per batch of 2 (host clock, pinned H2D included): "
        + ", ".join(f"{k} {v:.2f}" for k, v in eval_warm_ms.items()) + f"; card {smi}")
    del model

    # ---- 11. training: the flagship through ExperimentManager --------------
    import shutil

    from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.hooks import CheckpointHook
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.data import HostLoader, get_seg_transforms
    from multimodal_tta_tpu_torch.utils.metrics import set_random_seed

    t_train_phase = time.perf_counter()
    run_root = os.path.join(REPO, "build", "chip_smoke_train")  # build/ is in .gitignore
    shutil.rmtree(run_root, ignore_errors=True)

    t1 = time.perf_counter()
    train_set, val_set = hecktor_volumes(16, 21), hecktor_volumes(4, 22)
    data_s = time.perf_counter() - t1
    spec = get_seg_transforms(ndim=3, split="train", normalize=True, geom_aug=False, intensity_aug=False,
                              image_size=SHAPE[:3], intensity_policy=HECKTOR_POLICY,
                              channel_names=["ct", "pt"], on_device=True).device_spec()

    def make_manager(save_dir: str, **training) -> ExperimentManager:
        cfg = train_recipe(save_dir)
        cfg["training"].update(training)
        m = ExperimentManager(ConfigNode(cfg), device=dev)
        m.setup_model()
        m.setup_optimizer()
        m.setup_scheduler()
        m.train_loader = HostLoader(train_set, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                                    num_workers=4, seed=0)
        m.val_loader = HostLoader(val_set, batch_size=8, num_workers=2)
        m.device_transform = spec
        m.setup_trainer()
        return m

    def opt_tensors(optimizer) -> list:
        return [v for st in optimizer.state_dict()["state"].values() for v in st.values() if torch.is_tensor(v)]

    def snapshot(trainer) -> dict:
        st = trainer.state
        return {"model": {k: v.detach().clone() for k, v in st.model.state_dict().items()},
                "opt": [t.clone() for t in opt_tensors(st.optimizer)], "step": st.step,
                "lr": [g["lr"] for g in st.optimizer.param_groups],
                "scheduler": trainer.scheduler.state_dict(), "best_metrics": dict(trainer.best_metrics)}

    def restored(trainer, snap: dict) -> dict:
        """Which parts of ``trainer``'s state equal ``snap`` bitwise."""
        st = trainer.state
        sd, ot = st.model.state_dict(), opt_tensors(st.optimizer)
        return {"params": sd.keys() == snap["model"].keys() and all(torch.equal(sd[k], v)
                                                                     for k, v in snap["model"].items()),
                "optimizer": len(ot) == len(snap["opt"]) > 0
                and all(a.device == b.device and torch.equal(a, b) for a, b in zip(ot, snap["opt"]))
                and [g["lr"] for g in st.optimizer.param_groups] == snap["lr"],
                "step": st.step == snap["step"],
                "scheduler": trainer.scheduler.state_dict() == snap["scheduler"],
                "best_metrics": trainer.best_metrics == snap["best_metrics"]}

    class StepRecorder(HookBase):
        """Kernel launches of each training step, and its loss (the device
        tensor the trainer reads one step late)."""

        def __init__(self):
            self.launches, self.losses = [], []

        def _counts(self):
            return (fused_instance_norm.launches, fused_instance_norm.backward_launches,
                    instance_norm_backward_plain.cuda_calls)

        def before_train_step(self):
            self._at = self._counts()

        def after_train_step(self):
            self.launches.append(tuple(b - a for a, b in zip(self._at, self._counts())))
            self.losses.append(self.trainer._pending_loss)

    t1 = time.perf_counter()
    run_a = make_manager(os.path.join(run_root, "a"))
    setup_s = time.perf_counter() - t1
    model = run_a.model
    n_params = len(list(model.parameters()))
    recorder = StepRecorder()
    run_a.trainer.register_hooks([recorder])
    snaps = {}
    save = run_a.checkpoint_hook.save

    def save_and_snapshot(epoch: int, is_best: bool):  # what each checkpoint was written from
        save(epoch, is_best)
        snaps["best_model" if is_best else f"checkpoint_epoch_{epoch}"] = dict(snapshot(run_a.trainer), epoch=epoch)

    run_a.checkpoint_hook.save = save_and_snapshot
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    fused_instance_norm.launches = 0
    fused_instance_norm.backward_launches = 0
    minplus.launches = 0
    instance_norm_backward_plain.cuda_calls = 0
    # what each validation batch's min-plus launch is given and gives back,
    # held against the plain version after the run
    import multimodal_tta_tpu_torch.ops.surface as surface_module

    val_edt = []

    def recording_edt(pts, spacing, *, sqrt=False):
        out = squared_edt_volumes(pts, spacing, sqrt=sqrt)
        val_edt.append((pts.clone(), spacing, sqrt, out.clone()))
        return out

    surface_module.squared_edt_volumes = recording_edt
    t1 = time.perf_counter()
    try:
        history = run_a.train(2)
        sync()
    finally:
        surface_module.squared_edt_volumes = squared_edt_volumes
    train_wall_s = time.perf_counter() - t1
    train_launches = {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                      "minplus": minplus.launches, "plain_backward": instance_norm_backward_plain.cuda_calls}
    train_peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in recorder.losses]
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, params0[n])]
    n_steps = len(losses)
    n_val = 2 * len(range(0, len(val_set), 8))
    log(f"[train] UNet3D 32..512 bf16, {n_params} param tensors, adam lr 1e-5 poly, batch {TRAIN_BATCH}, "
        f"2 epochs of {len(train_set)} volumes + validation of {len(val_set)} (surface metrics on): "
        f"wall {train_wall_s:.2f} s (setup {setup_s:.2f} s, data made in {data_s:.2f} s); losses per step "
        f"{[round(v, 5) for v in losses]}; lr per epoch {[h['lr'] for h in history['train_history']]}; "
        f"{len(moved)}/{n_params} param tensors moved; launches per step (forward, backward, plain backward) "
        f"{recorder.launches}; over the run: {train_launches}; peak allocated {train_peak / 2**30:.2f} GiB; "
        f"card {smi}")
    for epoch, ev in enumerate(history["eval_history"]):
        log(f"[train] epoch {epoch} validation: " + ", ".join(f"{k} {v:.5g}" for k, v in ev.items()
                                                              if "/" not in k))
    if n_steps != 2 * len(train_set) // TRAIN_BATCH or not all(np.isfinite(losses)):
        raise AssertionError(f"training: {n_steps} steps, losses {losses}")
    if n_params != 82 or len(moved) != 82:
        raise AssertionError(f"training moved {len(moved)} of {n_params} param tensors (82 expected)")
    if any(s != (18, 18, 0) for s in recorder.launches):
        raise AssertionError(f"each step must launch 18 norm forward and 18 backward kernels and never the "
                             f"plain backward: {recorder.launches}")
    if train_launches != {"forward": 18 * (n_steps + n_val), "backward": 18 * n_steps, "minplus": n_val,
                          "plain_backward": 0}:
        raise AssertionError(f"training run launches {train_launches}")
    for pts, spacing, root, out in val_edt:
        ref = squared_edt_volumes_plain(pts, spacing, sqrt=root)
        equal = torch.equal(out, ref)
        log(f"[train] validation squared_edt_volumes {list(pts.shape)} spacing {tuple(spacing)} sqrt={root}, "
            f"{int(pts.flatten(1).any(1).sum())} of {pts.shape[0]} surfaces with points: bitwise equal to plain="
            f"{equal}, inf out {int(torch.isinf(out).sum())} (plain {int(torch.isinf(ref).sum())})")
        if not equal or pts.shape[0] != 2 * len(val_set):
            raise AssertionError(f"the validation batch's min-plus launch disagrees with plain at {list(pts.shape)}")
    if len(val_edt) != n_val:
        raise AssertionError(f"{len(val_edt)} squared EDT calls in validation, expected {n_val}")
    del val_edt, pts, out, ref
    for ev in history["eval_history"]:
        if not all(v == v and abs(v) != float("inf") for v in ev.values()) or "gtvt_hd95" not in ev:
            raise AssertionError(f"validation metrics not finite or incomplete: {ev}")
    ckpt_dir = os.path.join(run_root, "a", "checkpoints")
    written = sorted(os.listdir(ckpt_dir))
    want_files = sorted(f"{n}.{e}" for n in ("best_model", "checkpoint_epoch_0", "checkpoint_epoch_1")
                        for e in ("json", "msgpack"))
    with open(os.path.join(ckpt_dir, "best_model.json")) as f:
        sidecar = json.load(f)
    log(f"[train] checkpoints written: {written}; best_model.json {sidecar}")
    if written != want_files or sidecar.get("_format") != "msgpack" or "best_metrics" not in sidecar:
        raise AssertionError(f"checkpoint files {written}, sidecar {sidecar}")

    # a second manager resumes from best_model through training.resume, then
    # loads checkpoint_epoch_1 (written from the state the run ended with)
    run_b = make_manager(os.path.join(run_root, "b"), resume=os.path.join(ckpt_dir, "best_model"))
    got = restored(run_b.trainer, snaps["best_model"])
    resume_epoch = run_b.trainer.start_epoch
    # the restored state written again: the same bytes as the file it came from
    rewrite = rewrite_check(run_b.trainer.state, os.path.join(ckpt_dir, "best_model"),
                            os.path.join(run_root, "b", "rewritten"))
    log(f"[train] best_model.msgpack read by a fresh manager and written again: identical bytes "
        f"{rewrite['identical']} ({rewrite['bytes']} bytes)")
    if not rewrite["identical"]:
        raise AssertionError("best_model.msgpack read and written again differs")
    start_1 = run_b.checkpoint_hook.load(os.path.join(ckpt_dir, "checkpoint_epoch_1"))
    got_1 = restored(run_b.trainer, snaps["checkpoint_epoch_1"])
    live = {k: v for k, v in restored(run_a.trainer, snaps["checkpoint_epoch_1"]).items()
            if k in ("params", "optimizer", "step")}
    log(f"[train] resume from best_model (written at epoch {snaps['best_model']['epoch']}): restored bitwise "
        f"{got}, resumes at epoch {resume_epoch}; from checkpoint_epoch_1: {got_1}, resumes at epoch {start_1}; "
        f"the uninterrupted run's live state equals checkpoint_epoch_1: {live}")
    if not all(got.values()) or resume_epoch != snaps["best_model"]["epoch"] + 1:
        raise AssertionError("best_model did not restore bitwise or resumes at the wrong epoch")
    if not all(got_1.values()) or start_1 != 2 or not all(live.values()):
        raise AssertionError("checkpoint_epoch_1 did not restore bitwise")

    # the flagship's Adam checkpoint in every format: save and load timed
    # (the file cache warm), each load restoring checkpoint_epoch_1 bitwise;
    # the orbax reader's chunk decoding (the native zstd) timed apart
    from multimodal_tta_tpu_torch.core import orbax_format, zstd

    t1 = time.perf_counter()
    zstd.lib()  # g++ builds the native zstd decoder (csrc/zstd_decode.cpp) into build/native/ once
    zstd_build_s = time.perf_counter() - t1

    def resumed(st) -> bool:
        run_b.trainer.state = st
        return all(restored(run_b.trainer, snaps["checkpoint_epoch_1"]).values())

    ckpt_io = checkpoint_io(run_b.trainer.state, run_b.trainer.state, os.path.join(run_root, "io", "flagship"),
                            resumed)
    log(f"[train] checkpoint I/O, the flagship's Adam state (params, mu, nu; the file cache warm): "
        + "; ".join(f"{fmt} {r['bytes']} bytes, save {r['save_s']:.3f} s ({r['save_MBps']:.0f} MB/s), load "
                    f"{r['load_s']:.3f} s ({r['load_MBps']:.0f} MB/s), restored bitwise {r['restored']}"
                    for fmt, r in ckpt_io.items()) + f"; card {smi}")
    o = ckpt_io["orbax"]
    log(f"[train] orbax: {o['chunks']} chunks, {o['decoded_bytes']} bytes decoded by the native zstd (raw and RLE "
        f"blocks, the port's frames) in {o['decode_s']:.3f} s on a pool of {orbax_format.THREADS} threads "
        f"({o['decode_MBps']:.0f} MB/s); {o['bytes'] / ckpt_io['msgpack']['bytes']:.4f}x msgpack's bytes; "
        f"g++ build of the decoder {zstd_build_s:.2f} s; card {smi}")
    if not all(r["restored"] for r in ckpt_io.values()):
        raise AssertionError(f"a timed checkpoint did not restore bitwise: {ckpt_io}")

    # the reference's own orbax file (tests/data/orbax_reference, written by
    # the JAX package's save_checkpoint_sharded: tensorstore's level-1 frames)
    fixture = orbax_fixture_check()
    log(f"[train] the reference's orbax fixture ({fixture['leaves']} leaves, {fixture['chunks']} chunks, "
        f"{fixture['bytes']} bytes) read bitwise equal to its expected.npz: {fixture['bitwise']}; frames by mode "
        f"{fixture['modes']}; decode of its frames, {fixture['passes']} passes on one thread: "
        f"{fixture['decode_MBps']:.1f} MB/s; card {smi}")
    if not fixture["bitwise"] or not fixture["modes"].get("literals_huffman_4streams") \
            or not fixture["modes"].get("sequences_fse"):
        raise AssertionError(f"the orbax fixture: {fixture}")

    # the resumed state saved by CheckpointHook as orbax; a fresh manager
    # resumes from it through training.resume (its strict step below)
    orbax_hook = CheckpointHook(os.path.join(run_root, "orbax"), fmt="orbax")
    orbax_hook.trainer = run_b.trainer
    orbax_hook.save(1, is_best=False)  # checkpoint_epoch_1.orbax: checkpoint_epoch_1's state
    orbax_ckpt = os.path.join(run_root, "orbax", "checkpoint_epoch_1")
    run_c = make_manager(os.path.join(run_root, "c"), resume=orbax_ckpt)
    got_c = restored(run_c.trainer, snaps["checkpoint_epoch_1"])
    start_c = run_c.trainer.start_epoch
    log(f"[train] CheckpointHook(fmt=orbax) of the resumed state ({sorted(os.listdir(os.path.join(run_root, 'orbax')))},"
        f" {tree_bytes(orbax_ckpt + '.orbax')} bytes) resumed by a fresh manager through training.resume: restored "
        f"bitwise {got_c}, resumes at epoch {start_c}")
    if not all(got_c.values()) or start_c != 2:
        raise AssertionError("the orbax checkpoint did not restore bitwise")

    # one more step on the same batch, without and after the restart, in
    # strict mode (deterministic cuDNN algorithms, use_deterministic_algorithms)
    step_batch = {"image": np.stack([s["image"] for s in train_set[:TRAIN_BATCH]]),
                  "label": np.stack([s["label"] for s in train_set[:TRAIN_BATCH]])}
    set_random_seed(0, "strict")
    try:
        step_loss, step_launches = {}, {}

        def step_counts():
            return (fused_instance_norm.launches, fused_instance_norm.backward_launches, minplus.launches,
                    instance_norm_backward_plain.cuda_calls)

        for tag, run in (("uninterrupted", run_a), ("resumed", run_b), ("orbax_resumed", run_c)):
            at = step_counts()
            run.trainer.run_step(step_batch)
            step_loss[tag] = run.trainer.flush_step_metrics()["loss"]
            sync()
            step_launches[tag] = tuple(b - a for a, b in zip(at, step_counts()))
        orbax_step_launches = step_launches["orbax_resumed"]
    finally:
        set_random_seed(0, "practical")
    pa, pb = dict(run_a.model.named_parameters()), dict(run_b.model.named_parameters())
    pc = dict(run_c.model.named_parameters())
    bitwise = all(torch.equal(pa[n], pb[n]) for n in pa)
    bitwise_c = all(torch.equal(pa[n], pc[n]) for n in pa) and step_loss["orbax_resumed"] == step_loss["uninterrupted"]
    step_rel = max(float((pa[n] - pb[n]).abs().max()) / max(float(pa[n].abs().max()), 1e-30) for n in pa)
    loss_rel = abs(step_loss["resumed"] - step_loss["uninterrupted"]) / abs(step_loss["uninterrupted"])
    log(f"[train] one step after the restart vs without it (strict mode): loss {step_loss}, rel diff "
        f"{loss_rel:.3g} (limit {RESUME_STEP_REL}); params max rel diff {step_rel:.3g} (limit {RESUME_STEP_REL}); "
        f"bitwise equal={bitwise}")
    log(f"[train] the step after the orbax resume (strict mode): loss and params bitwise the uninterrupted run's: "
        f"{bitwise_c}; its launches (norm forward, backward, min-plus, plain backward) {orbax_step_launches}")
    if not (loss_rel <= RESUME_STEP_REL and step_rel <= RESUME_STEP_REL):
        raise AssertionError("the step after the restart differs from the step without it")
    if not bitwise_c or orbax_step_launches != (18, 18, 0, 0):
        raise AssertionError(f"the step after the orbax resume: bitwise {bitwise_c}, launches {orbax_step_launches}")
    del run_b, pb, run_c, pc

    # ---- 12. training parity: kernel against plain norm, f32, full width ----
    r = np.random.RandomState(23)
    small_batch = {"image": np.stack([np.stack([r.randn(16, 32, 32) * 200.0 - 100.0,
                                                np.abs(r.randn(16, 32, 32)) * 3.0], axis=-1)
                                      for _ in range(2)]).astype(np.float32),
                   "label": (r.rand(2, 16, 32, 32, 1) > 0.9).astype(np.float32)}
    parity = {}
    for plain in (False, True):
        m = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.float32, device=dev, seed=5)
        set_plain_norm(m, plain)
        cfg = ConfigNode({"task": {"seed": 0}, "training": {
            "optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}},
            "criterion": train_recipe("")["training"]["criterion"]}})
        trainer = SegTrainer(cfg, device_transform=spec, device=dev)
        trainer.setup(TrainState(model=m, optimizer=build_optimizer(cfg.training, m)[0]))
        src = {n: p.detach().clone() for n, p in m.named_parameters()}
        at = (fused_instance_norm.launches, fused_instance_norm.backward_launches)
        trainer.run_step(small_batch)
        loss = trainer.flush_step_metrics()["loss"]
        sync()
        ran = (fused_instance_norm.launches - at[0], fused_instance_norm.backward_launches - at[1])
        parity[plain] = (loss, torch.cat([(p.detach() - src[n]).flatten() for n, p in m.named_parameters()]), ran)
        del m, trainer
    (l_k, d_k, ran_k), (l_p, d_p, ran_p) = parity[False], parity[True]
    p_loss_rel = abs(l_k - l_p) / abs(l_p)
    p_delta_rel = float((d_k - d_p).norm() / d_p.norm())
    log(f"[train-parity] f32 training step [2,16,32,32,2] at full width, sgd, kernel vs plain norm: loss "
        f"{l_k:.6f} / {l_p:.6f} rel {p_loss_rel:.3g} (limit {TRAIN_LOSS_REL}); param deltas rel L2 "
        f"{p_delta_rel:.3g} (limit {TRAIN_DELTA_REL}); launches (forward, backward) kernel run {ran_k}, "
        f"plain run {ran_p}")
    if not (p_loss_rel <= TRAIN_LOSS_REL and p_delta_rel <= TRAIN_DELTA_REL):
        raise AssertionError("the training step through the kernel disagrees with the plain norm")
    if ran_k != (18, 18) or ran_p != (0, 0):
        raise AssertionError(f"parity runs launched {ran_k} / {ran_p}")

    # ---- 13. training timing ----------------------------------------------
    trainer = run_a.trainer
    dev_batches = [{"image": torch.from_numpy(np.stack([s["image"] for s in train_set[k:k + TRAIN_BATCH]])).to(
                        dev, torch.float16),
                    "label": torch.from_numpy(np.stack([s["label"] for s in train_set[k:k + TRAIN_BATCH]])).to(
                        dev, torch.uint8),
                    "_n_valid": TRAIN_BATCH} for k in (0, TRAIN_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(10):
        sync()
        t1 = time.perf_counter()
        trainer.run_step(dev_batches[i % 2])
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    trainer.flush_step_metrics()
    step_peak = torch.cuda.max_memory_allocated()
    warm = sorted(step_ms[2:])
    step_median = warm[len(warm) // 2] if len(warm) % 2 else 0.5 * (warm[len(warm) // 2 - 1] + warm[len(warm) // 2])
    val_ms = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        trainer.evaluation_strategy.evaluate_epoch(trainer.eval_state(), run_a.val_loader, device=dev)
        sync()
        val_ms.append((time.perf_counter() - t1) * 1e3)
    val_median = sorted(val_ms)[1]
    training = {"ms_per_step": step_ms, "median_warm_ms": step_median,
                "volumes_per_s": TRAIN_BATCH * 1e3 / step_median, "val_batch_ms": val_ms,
                "val_batch_median_ms": val_median, "val_batch_volumes": len(val_set),
                "peak_allocated_gib_2_epoch_run": train_peak / 2**30, "peak_allocated_gib_steps": step_peak / 2**30,
                "losses": losses, "launches": train_launches, "resume_step_bitwise": bitwise,
                "norm_calls_per_step_batch8": {"forward": norm_totals[TRAIN_BATCH][0],
                                               "backward": norm_totals[TRAIN_BATCH][1]}, "card": smi}
    log(f"[train-timing] batch {TRAIN_BATCH} [48,144,144,2], bf16, adam, device-resident batches: ms per step "
        f"{[round(t, 2) for t in step_ms]} -> median of the warm 8 {step_median:.2f} ms, "
        f"{TRAIN_BATCH * 1e3 / step_median:.2f} volumes/s; validation batch of {len(val_set)} volumes (surface "
        f"metrics on, H2D included) {[round(t, 2) for t in val_ms]} -> median {val_median:.2f} ms; peak "
        f"allocated {step_peak / 2**30:.2f} GiB in the timed steps, {train_peak / 2**30:.2f} GiB in the 2-epoch "
        f"run; card {smi}")
    log(f"[train] phases 11-13 took {time.perf_counter() - t_train_phase:.1f} s")
    trained_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}  # phase 15 adapts these
    del run_a, trainer, model, dev_batches
    # phase 20 distills from phase 11's best checkpoint
    teacher_root = os.path.join(REPO, "build", "chip_smoke_teacher")
    shutil.rmtree(teacher_root, ignore_errors=True)
    os.makedirs(teacher_root)
    for ext in (".msgpack", ".json"):
        shutil.copy(os.path.join(ckpt_dir, "best_model" + ext), os.path.join(teacher_root, "flagship" + ext))
    shutil.rmtree(run_root, ignore_errors=True)

    # ---- 14. the command-line entry points --------------------------------
    def reset_counts():
        fused_instance_norm.launches = 0
        fused_instance_norm.backward_launches = 0
        minplus.launches = 0
        instance_norm_backward_plain.cuda_calls = 0

    def read_counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches, "plain_backward": instance_norm_backward_plain.cuda_calls}

    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    cli_root = os.path.join(REPO, "build", "chip_smoke_cli")  # build/ is in .gitignore
    cli = cli_phase(dev, cli_root, reset_counts=reset_counts, read_counts=read_counts)
    cli_s = time.perf_counter() - t1
    log(f"[cli] fixture: {sum(CLI_CENTERS.values())} HECKTOR21 cases {CLI_SHAPE} (X,Y,Z) over {CLI_CENTERS}, "
        f"{cli['fixture_bytes'] / 2**20:.1f} MiB written in {cli['fixture_s']:.2f} s; g++ build of the native "
        f"decoder {cli['native_build_s']:.2f} s; decode of one CT volume "
        f"{cli['decode_ms_per_volume']['native']:.2f} ms native, {cli['decode_ms_per_volume']['python']:.2f} ms "
        f"Python; decodes by path over the phase {cli['decodes']}")
    for run_name in ("train", "train_device_cache"):
        r = cli[run_name]
        log(f"[cli] {run_name} ({r['format']} checkpoints): {r['train_volumes']} volumes, {r['steps']} steps in "
            f"{r['wall_s']:.2f} s; ms per step "
            f"(input path included) {[round(t, 2) for t in r['step_ms']]} -> median of the steps after an "
            f"epoch's first {r['median_step_ms']:.2f}, mean over each epoch's steps "
            f"{[round(t, 2) for t in r['epoch_ms_per_step']]}; wall per epoch (validation and checkpoints included) "
            f"{[round(t, 2) for t in r['epoch_s']]} s; the input path alone "
            f"{[round(t, 2) for t in r['input_alone_ms_per_batch']]} ms per batch; "
            f"losses {[round(v, 5) for v in r['losses']]}; launches per step {r['step_launches']}; over the "
            f"run {r['launches']} ({r['val_batches']} validation batches); validation {r['val_metrics']}"
            + (f"; store {r['store_bytes'] / 2**30:.3f} GiB staged in {r['stage_s']:.2f} s, batches bitwise "
               f"the host loader's: {r['batches_bitwise_host_loader']}" if "store_bytes" in r else ""))
        if any(s != {"forward": 18, "backward": 18, "minplus": 0, "plain_backward": 0} for s in r["step_launches"]):
            raise AssertionError(f"{run_name}: each step must launch 18 norm forward and 18 backward kernels")
        want = {"forward": 18 * (r["steps"] + r["val_batches"]), "backward": 18 * r["steps"],
                "minplus": r["val_batches"], "plain_backward": 0}
        steps = (r["steps_per_epoch"], r["steps"])
        if r["launches"] != want or steps != (CLI_STEPS_PER_EPOCH, 2 * CLI_STEPS_PER_EPOCH):
            raise AssertionError(f"{run_name}: launches {r['launches']}, {r['steps']} steps")
    for run_name, fwd_per_batch, bwd_per_batch, minplus_per_batch in (("adapt", 3, 1, 2), ("predict", 2, 1, 0)):
        r = cli[run_name]
        log(f"[cli] {run_name}: {r['wall_s']:.2f} s, {r['test_batches']} test batches, launches {r['launches']}, "
            f"model restored {r['model_restored']}; "
            + (f"from {r['checkpoint']} (cli.train's orbax checkpoint); " if "checkpoint" in r else "") + (
                f"metrics {r['metrics']}" if run_name == "adapt"
                else f"{r['cases']} cases written, foreground voxels {r['voxels']}"))
        b = r["test_batches"]
        if r["launches"] != {"forward": 18 * fwd_per_batch * b, "backward": 18 * bwd_per_batch * b,
                             "minplus": minplus_per_batch * b, "plain_backward": 0}:
            raise AssertionError(f"{run_name}: launches {r['launches']}")
    cli_launches = {k: sum(cli[n]["launches"][k] for n in ("train", "train_device_cache", "adapt", "predict"))
                    for k in ("forward", "backward", "minplus")}
    cli["launches"] = cli_launches
    cli["card"] = smi
    log(f"[cli] phase 14 took {cli_s:.1f} s; launches over the CLI runs {cli_launches}; card {smi}")
    # phase 22's NCCL probe and the torchrun command lines of phases 22-24
    # need only phase 14's fixture (or nothing): they run on a lane of their
    # own beside phases 15-21 (CliLane)
    lane_root = os.path.join(REPO, "build", "chip_smoke_cli_lane")
    shutil.rmtree(lane_root, ignore_errors=True)
    lane = CliLane({"nccl_probe": lambda: nccl_probe(os.path.join(lane_root, "probe")),
                    "data_parallel": lambda: dp_torchrun_cli(cli["manifest"], os.path.join(lane_root, "dp")),
                    "space_parallel": lambda: sp_torchrun_cli(cli["manifest"], os.path.join(lane_root, "sp")),
                    "adapters": lambda: ad_torchrun_cli(cli["manifest"], os.path.join(lane_root, "ad"))})

    # ---- 15. the TTA methods ---------------------------------------------
    from multimodal_tta_tpu_torch.conf import compose
    from multimodal_tta_tpu_torch.tta import MemoAdapter, SarAdapter

    t_tta = time.perf_counter()
    torch.cuda.empty_cache()
    tta_model = UNet3D(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512), strides=(2, 2, 2, 2),
                       num_res_units=2, dtype=torch.bfloat16, device=dev, seed=0)
    tta_model.load_state_dict(trained_sd)  # phase 11's trained weights
    vols = hecktor_volumes(BATCH * TTA_BATCHES, 31)
    tta_batches = [{"image": np.stack([v["image"] for v in vols[k:k + BATCH]]),
                    "label": np.stack([v["label"] for v in vols[k:k + BATCH]]),
                    "domain": [v["domain"] for v in vols[k:k + BATCH]]} for k in range(0, len(vols), BATCH)]
    tta = tta_phase(dev, tta_model, tta_batches, reset_counts=reset_counts, read_counts=read_counts)
    tta_launches = {"forward": 0, "backward": 0, "minplus": 0}
    tta_log = {}
    for tag, r in tta.items():
        want_f, want_b = expected_tta_launches(r["adapter"], r["batches"], r["traces"])
        want = {"forward": want_f, "backward": want_b, "minplus": r["batches"], "plain_backward": 0}
        ms = r["ms_per_batch"]
        med = float(np.median(ms[1:]))
        m = r["metrics"]
        log(f"[tta] {tag}: {r['batches']} batches of {BATCH}, ms per batch {[round(t, 2) for t in ms]} -> median "
            f"after the first {med:.2f}; launches {r['launches']} (derived {want}); avg_dc {m['avg_dc']:.6f} "
            f"hd95 {m['gtvt_hd95']:.4f} loss {m['loss']:.5f}; entropy traces "
            f"{[[round(e, 6) for e in t] for t in r['traces']]}; card {smi}")
        if r["launches"] != want:
            raise AssertionError(f"{tag}: launches {r['launches']}, derived from the step structure {want}")
        for k in tta_launches:
            tta_launches[k] += r["launches"][k]
        tta_log[tag] = {"ms_per_batch": ms, "median_ms_after_first": med, "launches": r["launches"],
                        "traces": r["traces"], "metrics": {k: v for k, v in m.items() if "/" not in k}}
        if getattr(r["adapter"], "method", "") == "sar":
            resets = sar_resets(r["adapter"], r["traces"])
            episodic = int(r["adapter"].episodic)
            log(f"[tta] {tag}: recovery resets per batch {resets} (derived from the traces), source copies in "
                f"the adaptation {r['source_copies']}")
            if r["source_copies"] != [n + episodic for n in resets]:
                raise AssertionError(f"{tag}: source copies {r['source_copies']}, resets derived {resets}")
    if not sum(sar_resets(tta["sar_recovery_reset"]["adapter"], tta["sar_recovery_reset"]["traces"])):
        raise AssertionError("sar_recovery_reset: no recovery reset")
    frozen = {tag: [len(t) - active_steps(tta[tag]["adapter"], t) for t in tta[tag]["traces"]]
              for tag in ("tent_consistency_early_stop_dropout", "tent_early_stop_frozen_tail")}
    log(f"[tta] early stop: frozen steps per batch {frozen}")
    if not any(frozen["tent_consistency_early_stop_dropout"]) or frozen["tent_early_stop_frozen_tail"] != [2] * TTA_BATCHES:
        raise AssertionError(f"early stop: frozen steps {frozen}")
    del tta

    # peak memory of one adaptation of a batch: MEMO (n_views 4, the views'
    # gradients accumulated one view at a time) against Tent
    x_peak = torch.from_numpy(tta_batches[0]["image"]).to(dev)
    peaks = {}
    for name, cls in (("tent", None), ("memo", MemoAdapter)):
        cfg = compose(os.path.join(REPO, "configs"), "config", tta_overrides(f"tta={name}", "tta.steps=1"))
        ad = (cls or TentAdapter)(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        fn = ad.make_adapt_fn(tta_model)
        fn(tta_model, x_peak, BATCH)  # first call: cuDNN set-up and the allocator's pools
        ad.restore()
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(tta_model, x_peak, BATCH)
        sync()
        peaks[name] = {"base_gib": base / 2**30, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "n_views": getattr(ad, "n_views", 1)}
        peaks[name]["step_gib"] = peaks[name]["peak_gib"] - peaks[name]["base_gib"]
        ad.restore()
    peak_ratio = peaks["memo"]["step_gib"] / peaks["tent"]["step_gib"]
    log(f"[tta] peak allocated memory of one step at batch {BATCH} [48,144,144,2] bf16: Tent "
        f"{peaks['tent']['peak_gib']:.3f} GiB ({peaks['tent']['step_gib']:.3f} above the {peaks['tent']['base_gib']:.3f} "
        f"held before it), MEMO n_views {peaks['memo']['n_views']} {peaks['memo']['peak_gib']:.3f} GiB "
        f"({peaks['memo']['step_gib']:.3f} above); MEMO/Tent above the base {peak_ratio:.3f} (limit 1.5); card {smi}")
    if not (peaks["memo"]["n_views"] == 4 and peak_ratio <= 1.5):
        raise AssertionError("a MEMO step holds more than one view's activations")
    del x_peak

    # f32 SAR and MEMO steps at full width on a small input, kernel vs plain
    # norm (phase 12's limits: entropy relative, norm-param deltas rel L2)
    small = torch.randn((1, 16, 32, 32, 2), generator=data, device=dev) * 100
    step_parity = {}
    for name, cls, tta_cfg, per_step in (
        ("sar", SarAdapter, {"steps": 1, "lr": 1e-2, "episodic": True, "entropy_focus": "uncertain",
                             "margin_ratio": 1.0, "reset_floor_ratio": 0.0}, (36, 36)),
        ("memo", MemoAdapter, {"steps": 1, "lr": 1e-2, "episodic": True, "entropy_focus": "uncertain",
                               "n_views": 4}, (144, 72)),
    ):
        res = {}
        for plain in (False, True):
            m = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.float32, device=dev, seed=7)
            set_plain_norm(m, plain)
            cfg = ConfigNode({"task": {"seed": 0}, "training": {"criterion": {"sigmoid": True}},
                              "tta": dict(tta_cfg, method=name)})
            ad = cls(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
            fn = ad.make_adapt_fn(m)
            src = [p.detach().clone() for p in ad._trainable]
            at = (fused_instance_norm.launches, fused_instance_norm.backward_launches)
            fn(m, small, 1)
            sync()
            ran = (fused_instance_norm.launches - at[0], fused_instance_norm.backward_launches - at[1])
            res[plain] = (ad.last_entropy, torch.cat([(p.detach() - s_).flatten() for p, s_ in zip(ad._trainable, src)]),
                          ran)
            del m, ad, fn
        (e_k, d_k, ran_k), (e_p, d_p, ran_p) = res[False], res[True]
        e_rel, d_rel = abs(e_k - e_p) / abs(e_p), float((d_k - d_p).norm() / d_p.norm())
        step_parity[name] = {"entropy_rel": e_rel, "delta_rel": d_rel, "launches_kernel": ran_k,
                             "launches_plain": ran_p}
        log(f"[tta-parity] f32 {name} step [1,16,32,32,2] at full width, kernel vs plain norm: entropy "
            f"{e_k:.6f} / {e_p:.6f} rel {e_rel:.3g} (limit {TRAIN_LOSS_REL}); norm-param deltas rel L2 {d_rel:.3g} "
            f"(limit {TRAIN_DELTA_REL}); launches (forward, backward) kernel run {ran_k}, plain run {ran_p}")
        if not (e_rel <= TRAIN_LOSS_REL and d_rel <= TRAIN_DELTA_REL):
            raise AssertionError(f"the {name} step through the kernel disagrees with the plain norm")
        if ran_k != per_step or ran_p != (0, 0):
            raise AssertionError(f"{name} parity runs launched {ran_k} / {ran_p}")

    # the streams through cli.adapt on phase 14's fixture and checkpoint
    t1 = time.perf_counter()
    stream = stream_phase(dev, cli["manifest"], cli["best"], cli_root, reset_counts=reset_counts,
                          read_counts=read_counts)
    stream_s = time.perf_counter() - t1
    for name, r in stream.items():
        m = r["metrics"]
        log(f"[tta-stream] {name}: {r['batches']} batches over {list(STREAM_ORDER)} in {r['wall_s']:.2f} s; "
            f"avg_dc {m['avg_dc']} reanchors {m['reanchors']} policy {m['policy']}; "
            + (f"gate threshold {r['gate_threshold']:.6g} (the probe's gate entropies "
               f"{[round(g, 6) for g in r['gate_probe']]}), forward batches {m['gate/forward_batches']}, adapt "
               f"batches {m['gate/adapt_batches']}, escalations {m['gate/escalations']}; " if "gate_probe" in r else "")
            + f"positions {[(p['domain'], p['mode'], p['reanchored']) for p in m['positions']]}; launches "
            f"{r['launches']} (derived {r['want']}); card {smi}")
        if r["launches"] != {**r["want"], "minplus": 0, "plain_backward": 0}:
            raise AssertionError(f"{name}: launches {r['launches']}, derived {r['want']}")
        for k in ("forward", "backward"):
            tta_launches[k] += r["launches"][k]
        tta_log[name] = {k: v for k, v in r.items() if k != "metrics"}
        tta_log[name]["metrics"] = {k: v for k, v in m.items() if k != "positions"}
    tta_s = time.perf_counter() - t_tta
    tta_log.update(peak_memory=peaks, memo_over_tent_step_memory=peak_ratio, step_parity=step_parity,
                   stream_s=stream_s, launches=tta_launches, card=smi)
    log(f"[tta] phase 15 took {tta_s:.1f} s (streams {stream_s:.1f} s); launches {tta_launches}; card {smi}")
    del tta_model, tta_batches

    # ---- 16. the BraTS recipe of train_brats.sh ------------------------------
    from collections import Counter

    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
    from multimodal_tta_tpu_torch.models import MultimodalUNetMidFusion

    t_brats = time.perf_counter()
    torch.cuda.empty_cache()
    brats = {"card": smi}
    brats_launches = {"forward": 0, "backward": 0, "minplus": 0}

    def add_launches(counts: dict) -> None:
        for k in brats_launches:
            brats_launches[k] += counts.get(k, 0)

    # 16.1: one forward of the mid-fusion model at full width on a BraTS batch
    mid = MultimodalUNetMidFusion(num_modalities=4, num_classes=3, dtype=torch.bfloat16, remat=True, device=dev,
                                  seed=0)
    n_params, n_norm = len(list(mid.parameters())), sum(norm_param_mask(mid).values())
    xb = torch.from_numpy(np.stack([v["image"] for v in brats_volumes(BRATS_BATCH, BRATS_SHAPE, seed=40)])).to(dev)
    shapes16 = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kw: shapes16.append((tuple(args[0].permute(0, 2, 3, 4, 1).shape), kw["relu"])),
        with_kwargs=True) for m in mid.modules() if isinstance(m, InstanceNorm)]
    with torch.no_grad():
        sync()
        reset_counts()
        logits, dom = mid(xb, return_domain_logits=True)
        sync()
        fwd16 = read_counts()
        for h in hooks:
            h.remove()
        set_plain_norm(mid, True)
        logits_plain = mid(xb)
        fwd16_plain_ms = cuda_ms(lambda: mid(xb), iters=3, warmup=1)
        set_plain_norm(mid, False)
        fwd16_ms = cuda_ms(lambda: mid(xb), iters=3, warmup=1)
    add_launches(fwd16)
    rel16 = float((logits - logits_plain).norm() / logits_plain.norm())
    # the same weights in f32: kernel vs plain norm there, and how far bf16
    # arithmetic itself (the plain norm's bf16 logits) is from f32
    mid32 = MultimodalUNetMidFusion(num_modalities=4, num_classes=3, dtype=torch.float32, device=dev, seed=None)
    mid32.load_state_dict(mid.state_dict())
    with torch.no_grad():
        logits32 = mid32(xb)
        set_plain_norm(mid32, True)
        logits32_plain = mid32(xb)
    rel16_f32 = float((logits32 - logits32_plain).norm() / logits32_plain.norm())
    rel16_bf16 = float((logits_plain - logits32_plain).norm() / logits32_plain.norm())
    del mid32, logits32, logits32_plain
    brats["forward"] = {"params": [n_params, n_norm], "launches": fwd16, "logits_rel_l2_plain": rel16,
                        "f32_logits_rel_l2_plain": rel16_f32, "bf16_plain_rel_l2_f32": rel16_bf16,
                        "domain_logits": list(dom.shape), "ms": fwd16_ms, "plain_norm_ms": fwd16_plain_ms}
    log(f"[brats] mid-fusion 32..512 bf16, {n_params} param tensors ({n_norm} norm), forward on "
        f"{list(xb.shape)}: logits {list(logits.shape)} finite={bool(torch.isfinite(logits).all())}, domain logits "
        f"{list(dom.shape)}; launches {fwd16} ({len(shapes16)} norm calls); kernel vs plain norm rel L2 {rel16:.3g} "
        f"in bf16 (limit: the plain norm's bf16 logits vs f32, {rel16_bf16:.3g}), {rel16_f32:.3g} in f32 (limit "
        f"{LOGITS_REL_L2}); forward {fwd16_ms:.2f} ms (plain norm {fwd16_plain_ms:.2f} ms); card {smi}")
    if (n_params, n_norm) != BRATS_PARAMS:
        raise AssertionError(f"mid-fusion: {n_params} tensors, {n_norm} norm ({BRATS_PARAMS} expected)")
    if tuple(logits.shape) != (BRATS_BATCH,) + BRATS_SHAPE + (3,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("mid-fusion logits have the wrong shape or are not finite")
    if tuple(dom.shape) != (4 * BRATS_BATCH, 4) or fwd16["forward"] != BRATS_NORMS or len(shapes16) != BRATS_NORMS:
        raise AssertionError(f"mid-fusion: domain logits {list(dom.shape)}, launches {fwd16}")
    # bf16: a 1-ulp rounding flip in a few 1e-5 of a norm's outputs (the
    # kernel's statistics are as close to f64 as the plain norm's) grows
    # through the 19 norms in series of a random-weight network; the
    # kernel must move the bf16 logits less than bf16 arithmetic itself does
    if not (rel16_f32 <= LOGITS_REL_L2 and rel16 <= rel16_bf16):
        raise AssertionError("the mid-fusion forward through the kernel disagrees with the plain norm")
    del logits, logits_plain, dom, mid

    # 16.2: both norm kernels at every distinct norm shape of that forward,
    # bf16 and f32, against the plain versions; their times per forward
    brats_regimes = {}
    for shape, _ in sorted(set(shapes16)):
        for dtype in (torch.bfloat16, torch.float32):
            err, dx_err, pf, pb = check_norm_shape(shape, dtype, "brats")
            max_abs_err, backward_err = max(max_abs_err, err), max(backward_err, dx_err)
            brats_regimes[f"{list(shape)} {str(dtype)[6:]}"] = {"forward": pf.regime, "backward": pb.regime}
    brats_norm = time_norm_calls(Counter(shapes16))
    log(f"[brats] one mid-fusion forward's {len(shapes16)} norm calls, bf16 batch {BRATS_BATCH}: forward kernel "
        f"{brats_norm[0]['ms']:.4f} ms, plain {brats_norm[0]['plain_ms']:.4f} ms, library "
        f"{brats_norm[0]['library_ms']:.4f} ms, bound {brats_norm[0]['bound_ms']:.4f} ms; backward kernel "
        f"{brats_norm[1]['ms']:.4f} ms, plain {brats_norm[1]['plain_ms']:.4f} ms, library "
        f"{brats_norm[1]['library_ms']:.4f} ms, bound {brats_norm[1]['bound_ms']:.4f} ms; regimes {brats_regimes}; "
        f"card {smi}")
    brats["regimes"] = brats_regimes

    # 16.3 and 16.5: the recipe trained through ExperimentManager, then served
    brats_root = os.path.join(REPO, "build", "chip_smoke_brats")  # build/ is in .gitignore
    served = brats_train_and_serve(dev, os.path.join(brats_root, "serve"), reset_counts=reset_counts,
                                   read_counts=read_counts)
    tr = served["train"]
    add_launches(tr["launches"])
    log(f"[brats] training (train_brats.sh: adam 1e-4, remat, batch {BRATS_BATCH}, modality dropout) 2 epochs of "
        f"{BRATS_TRAIN_VOLUMES} volumes {list(BRATS_SHAPE)} + validation of {BRATS_VAL_VOLUMES} (surface metrics): "
        f"wall {tr['wall_s']:.2f} s; losses {[round(v, 5) for v in tr['losses']]}; step ms {[round(t, 1) for t in tr['step_ms']]}; "
        f"launches per step {tr['step_launches']} (derived {tr['step_want']}); over the run {tr['launches']} "
        f"(derived {tr['want']}); unmoved {tr['frozen']}; validation EDT {tr['edt']}; peak allocated "
        f"{tr['peak_gib']:.2f} GiB; validation {tr['val']}; card {smi}")
    log(f"[brats] warm training steps on device batches: {[round(t, 1) for t in tr['warm_step_ms']]} ms -> median "
        f"{tr['median_step_ms']:.2f} ms, {tr['volumes_per_s']:.3f} volumes/s, peak allocated "
        f"{tr['warm_peak_gib']:.2f} GiB; card {smi}")
    for tag, r in served["tta"].items():
        add_launches(r["launches"])
        m_ = r["metrics"]
        log(f"[brats] evaluate {tag}: ms per batch {[round(t, 1) for t in r['ms_per_batch']]}; launches "
            f"{r['launches']} (derived {r['want']}); avg_dc {m_['avg_dc']:.5f} et/tc/wt dc {m_['et_dc']:.5f} "
            f"{m_['tc_dc']:.5f} {m_['wt_dc']:.5f} hd95 {m_['avg_hd95']:.3f} loss {m_['loss']:.5f}; entropy "
            f"{r['traces']}; card {smi}")
    ts = served["tent_step"]
    add_launches(ts["launches"])
    log(f"[brats] one Tent step at batch {BRATS_BATCH}: {ts['ms']:.1f} ms, gradient in {ts['grad_reached']}/"
        f"{ts['norm_tensors']} norm tensors, launches {ts['launches']} (derived {ts['want']}); peak allocated "
        f"{ts['peak_gib']:.3f} GiB ({ts['peak_gib'] - ts['held_gib']:.3f} above the {ts['held_gib']:.3f} held); "
        f"card {smi}")
    for proto, r in served["serving"].items():
        add_launches(r["launches"])
        log(f"[brats] serving {proto}: ms per step {[round(t, 1) for t in r['ms_per_step']]}, "
            f"{r['volumes_per_s']:.3f} volumes/s; launches {r['launches']} (derived {r['want']}); card {smi}")
    brats.update(train={k: v for k, v in tr.items()}, tta=served["tta"], tent_step=ts, serving=served["serving"])

    # the EDT of one evaluated batch at the BraTS shape: 12 surfaces (2
    # samples x 3 regions, prediction and label), one launch, vs plain
    model16 = served["model"]
    b0 = served["batches"][0]
    with torch.no_grad():
        prob16 = torch.sigmoid(model16(torch.from_numpy(b0["image"]).to(dev)))
    pred16 = (prob16 >= BRATS_THRESHOLD).permute(0, 4, 1, 2, 3).reshape(-1, *BRATS_SHAPE)
    gt16 = (torch.from_numpy(b0["label"]).to(dev) > 0.5).permute(0, 4, 1, 2, 3).reshape(-1, *BRATS_SHAPE)
    surf16 = extract_surface(torch.cat([gt16, pred16]))
    before = minplus.launches
    edt16 = squared_edt_volumes(surf16, (1.0, 1.0, 1.0), sqrt=True)
    sync()
    edt16_launches = minplus.launches - before
    edt16_equal = torch.equal(edt16, squared_edt_volumes_plain(surf16, (1.0, 1.0, 1.0), sqrt=True))
    edt16_ms = min(cuda_ms(lambda: squared_edt_volumes(surf16, (1.0, 1.0, 1.0), sqrt=True)) for _ in range(3))
    edt16_plain_ms = cuda_ms(lambda: squared_edt_volumes_plain(surf16, (1.0, 1.0, 1.0), sqrt=True), iters=1,
                             warmup=0)
    edt16_ops = 2 * surf16.numel() * sum(BRATS_SHAPE)
    t16_o, t16_b = edt16_ops / FP32_ADDMIN_OPS * 1e3, surf16.numel() * 5 / HBM_BYTES_PER_S * 1e3
    vp16 = volume_plan_for(surf16)
    brats["edt"] = {"surfaces": list(surf16.shape), "with_points": int(surf16.flatten(1).any(1).sum()),
                    "bitwise_plain": edt16_equal, "launches": edt16_launches, "ms": edt16_ms,
                    "plain_ms": edt16_plain_ms, "bound_ms": max(t16_o, t16_b),
                    "bound_by": "operations" if t16_o >= t16_b else "bytes",
                    "bound_at_probe_rate_ms": edt16_ops / probe[1] / 1e9,
                    "plan": {"threads": vp16.threads, "smem_bytes": vp16.smem_bytes,
                             "passes": [[q.n, q.kind, q.rows, q.tiles] for q in vp16.passes]}}
    log(f"[brats] squared_edt_volumes of one evaluated batch ({list(surf16.shape)}, spacing 1 mm, root written): "
        f"{edt16_launches} launch, bitwise equal to plain={edt16_equal}; kernel {edt16_ms:.4f} ms, plain "
        f"{edt16_plain_ms:.1f} ms, bound {max(t16_o, t16_b):.4f} ms (operations at {FP32_ADDMIN_OPS / 1e12:.1f} T "
        f"add-or-min/s; {edt16_ops / probe[1] / 1e9:.4f} ms at the probe's rate); plan {brats['edt']['plan']}; "
        f"card {smi}")
    if not edt16_equal or edt16_launches != 1:
        raise AssertionError("the min-plus kernel disagrees with plain at the BraTS shape")
    del prob16, pred16, gt16, surf16, edt16, model16, served

    # 16.4: remat changes no numbers; the kernel against the plain norm, f32
    # [64,96,64]: its deepest norms span 4x6x4 voxels (over a few voxels the
    # variance is small and the two norms' f32 sums differ visibly)
    vol16 = brats_volumes(1, (64, 96, 64), seed=45)[0]
    small16 = {"image": vol16["image"][None], "label": vol16["label"][None]}
    cfg16 = ConfigNode({"task": {"seed": 0}, "training": {
        "optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}},
        "criterion": compose(os.path.join(REPO, "configs"), "config", brats_overrides()).training.criterion
        .to_container()}})
    parity16 = {}
    for tag, remat, plain in (("no_remat", False, False), ("remat", True, False), ("remat_plain", True, True)):
        m16 = MultimodalUNetMidFusion(num_modalities=4, num_classes=3, dtype=torch.float32, remat=remat, device=dev,
                                      seed=5)
        set_plain_norm(m16, plain)
        trainer = SegTrainer(cfg16, device_transform={"normalize": False}, device=dev)
        trainer.setup(TrainState(model=m16, optimizer=build_optimizer(cfg16.training, m16)[0]))
        src = {n: p.detach().clone() for n, p in m16.named_parameters()}
        reset_counts()
        trainer.run_step(small16)
        loss = trainer.flush_step_metrics()["loss"]
        sync()
        parity16[tag] = (loss, torch.cat([(p.detach() - src[n]).flatten() for n, p in m16.named_parameters()]),
                         read_counts())
        del m16, trainer
    for a, b_, what in (("remat", "no_remat", "remat vs none"), ("remat", "remat_plain", "kernel vs plain norm")):
        (la, da, ca), (lb, db, cb) = parity16[a], parity16[b_]
        l_rel, d_rel = abs(la - lb) / abs(lb), float((da - db).norm() / db.norm())
        brats[f"parity_{a}_vs_{b_}"] = {"loss_rel": l_rel, "delta_rel": d_rel, "bitwise": torch.equal(da, db),
                                        "launches": [ca, cb]}
        log(f"[brats-parity] f32 training step [1,64,96,64,4] at full width, sgd, {what}: loss {la:.6f} / {lb:.6f} "
            f"rel {l_rel:.3g} (limit {TRAIN_LOSS_REL}); param deltas rel L2 {d_rel:.3g} (limit {TRAIN_DELTA_REL}), "
            f"bitwise {torch.equal(da, db)}; launches {ca} / {cb}")
        if not (l_rel <= TRAIN_LOSS_REL and d_rel <= TRAIN_DELTA_REL):
            raise AssertionError(f"brats training step: {what} disagree")
    want16 = {"no_remat": (BRATS_NORMS, BRATS_NORMS), "remat": (2 * BRATS_NORMS, BRATS_NORMS), "remat_plain": (0, 0)}
    got16 = {k: (v[2]["forward"], v[2]["backward"]) for k, v in parity16.items()}
    if got16 != want16 or any(v[2]["plain_backward"] for k, v in parity16.items() if k != "remat_plain"):
        raise AssertionError(f"brats parity launches {got16}, expected {want16}")
    del parity16

    # 16.6: the other models at full width
    others = brats_other_models(dev, BRATS_SHAPE, reset_counts=reset_counts, read_counts=read_counts)
    for name, r in others.items():
        add_launches(r["launches_per_forward"])
        add_launches(r["tent_step_launches"])
        log(f"[brats] {name} 32..512 bf16 on [1,{','.join(map(str, BRATS_SHAPE))},4]: {r['params']} param tensors "
            f"({r['norm_tensors']} norm), logits {r['logits']} finite={r['finite']}, kernel vs plain norm rel L2 "
            f"{r['logits_rel_l2_plain']:.3g}; launches per forward {r['launches_per_forward']}, Tent step "
            f"{r['tent_step_launches']}, gradient in {r['grad_reached']}/{r['norm_tensors']} norm tensors; first "
            f"forward {r['forward_ms_first']:.1f} ms, first Tent step {r['tent_step_ms_first']:.1f} ms; card {smi}")
    per_fwd = {"unet_multimodal_late": 72, "unet_ws": 16, "segresnet": 0}
    for name, r in others.items():
        f = per_fwd[name]
        if (r["launches_per_forward"]["forward"] != f or r["tent_step_launches"]["forward"] != f
                or r["tent_step_launches"]["backward"] != f or r["grad_reached"] != r["norm_tensors"]
                or not r["finite"] or (f and not r["logits_rel_l2_plain"] <= LOGITS_REL_L2)):
            raise AssertionError(f"{name}: {r}")
    brats["other_models"] = others

    # 16.7: the CLIs on a BraTS NIfTI fixture
    bcli = brats_cli(dev, os.path.join(brats_root, "cli"), reset_counts=reset_counts, read_counts=read_counts)
    for call in ("train", "adapt"):
        add_launches(bcli[call]["launches"])
        log(f"[brats] cli.{call}: {bcli[call]['wall_s']:.2f} s, launches {bcli[call]['launches']} (derived "
            f"{bcli[call]['want']}); " + (f"losses {bcli['train']['losses']}, validation {bcli['train']['val']}"
                                        if call == "train" else f"metrics {bcli['adapt']['metrics']}") + f"; card {smi}")
    brats["cli"] = bcli
    shutil.rmtree(brats_root, ignore_errors=True)
    brats["launches"] = brats_launches
    brats_s = time.perf_counter() - t_brats
    brats["phase_s"] = brats_s
    log(f"[brats] phase 16 took {brats_s:.1f} s; launches {brats_launches}; card {smi}")

    # ---- 17. the transformer segmenters --------------------------------------
    from multimodal_tta_tpu_torch.registry import get_model

    t_tr = time.perf_counter()
    torch.cuda.empty_cache()
    transformers = {"card": smi}
    tr_launches = {"forward": 0, "backward": 0, "minplus": 0}
    tr_root = os.path.join(REPO, "build", "chip_smoke_transformers")  # build/ is in .gitignore

    def add_tr(counts: dict) -> None:
        for k in tr_launches:
            tr_launches[k] += counts.get(k, 0)

    x17 = norm_fn(torch.from_numpy(np.stack([v["image"] for v in hecktor_volumes(BATCH, 55)])).to(dev))
    for name, (per_fwd17, want_params) in TRANSFORMERS.items():
        rec17 = transformers[name] = {}
        # 17.1: one forward at the paper widths on a HECKTOR21 batch, bf16
        cfg17 = compose(os.path.join(REPO, "configs"), "config", transformer_overrides(name))
        build = get_model(name).from_config
        t1 = time.perf_counter()
        tm = build(cfg17.model, dtype=torch.bfloat16, remat=False, image_size=SHAPE[:3], device=dev, seed=0)
        built_s = time.perf_counter() - t1
        n_params, n_norm = len(list(tm.parameters())), sum(norm_param_mask(tm).values())
        shapes17 = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, kw: shapes17.append((tuple(args[0].permute(0, 2, 3, 4, 1).shape), kw["relu"])),
            with_kwargs=True) for m in tm.modules() if isinstance(m, InstanceNorm)]
        with torch.no_grad():
            sync()
            reset_counts()
            logits = tm(x17)
            sync()
            fwd17 = read_counts()
            for h in hooks:
                h.remove()
            set_plain_norm(tm, True)
            logits_plain = tm(x17)
            plain_ms17 = cuda_ms(lambda: tm(x17), iters=3, warmup=1)
            set_plain_norm(tm, False)
            ms17 = cuda_ms(lambda: tm(x17), iters=3, warmup=1)
        add_tr(fwd17)
        rel = float((logits - logits_plain).norm() / logits_plain.norm())
        tm32 = build(cfg17.model, dtype=torch.float32, remat=False, image_size=SHAPE[:3], device=dev, seed=None)
        tm32.load_state_dict(tm.state_dict())
        with torch.no_grad():
            logits32 = tm32(x17)
            set_plain_norm(tm32, True)
            logits32_plain = tm32(x17)
        rel_f32 = float((logits32 - logits32_plain).norm() / logits32_plain.norm())
        rel_bf16 = float((logits_plain - logits32_plain).norm() / logits32_plain.norm())
        finite = bool(torch.isfinite(logits).all())
        rec17["forward"] = {"params": [n_params, n_norm], "launches": fwd17, "norm_calls": len(shapes17),
                            "logits_rel_l2_plain": rel, "f32_logits_rel_l2_plain": rel_f32,
                            "bf16_plain_rel_l2_f32": rel_bf16, "ms": ms17, "plain_norm_ms": plain_ms17,
                            "built_s": built_s, "weights": sum(p.numel() for p in tm.parameters())}
        log(f"[transformer] {name} bf16 (configs/model/{name}.yaml), {n_params} param tensors ({n_norm} norm), "
            f"{rec17['forward']['weights']} weights, built in {built_s:.1f} s; forward on {list(x17.shape)}: logits "
            f"{list(logits.shape)} finite={finite}; launches {fwd17} ({len(shapes17)} norm calls); kernel vs plain "
            f"norm rel L2 {rel:.3g} in bf16 (limit {LOGITS_REL_L2}, else the plain norm's bf16 logits vs f32, "
            f"{rel_bf16:.3g}), {rel_f32:.3g} in f32 (limit {LOGITS_REL_L2}); forward {ms17:.2f} ms (plain norm "
            f"{plain_ms17:.2f} ms); card {smi}")
        del tm32, logits32, logits32_plain
        if (n_params, n_norm) != want_params:
            raise AssertionError(f"{name}: {n_params} tensors, {n_norm} norm ({want_params} expected)")
        if tuple(logits.shape) != (BATCH,) + SHAPE[:3] + (1,) or not finite:
            raise AssertionError(f"{name} logits have the wrong shape or are not finite")
        if fwd17["forward"] != per_fwd17 or len(shapes17) != per_fwd17:
            raise AssertionError(f"{name}: launches {fwd17}, {len(shapes17)} norm calls ({per_fwd17} expected)")
        if not (rel <= LOGITS_REL_L2 or (rel <= rel_bf16 and rel_f32 <= LOGITS_REL_L2)):
            raise AssertionError(f"the {name} forward through the kernel disagrees with the plain norm")
        del logits, logits_plain, tm

        # 17.2: both norm kernels at every norm shape of that forward, bf16
        # and f32, against the plain versions; their times per forward
        regimes17 = {}
        for shape, _ in sorted(set(shapes17)):
            for dtype in (torch.bfloat16, torch.float32):
                err, dx_err, pf, pb = check_norm_shape(shape, dtype, name)
                max_abs_err, backward_err = max(max_abs_err, err), max(backward_err, dx_err)
                regimes17[f"{list(shape)} {str(dtype)[6:]}"] = {"forward": pf.regime, "backward": pb.regime}
        norm17 = time_norm_calls(Counter(shapes17))
        rec17.update(regimes=regimes17, norm_shapes=sorted(Counter(shapes17).items()),
                     norm={"forward": norm17[0], "backward": norm17[1]})
        log(f"[transformer] {name}: one forward's {len(shapes17)} norm calls, bf16 batch {BATCH}: forward kernel "
            f"{norm17[0]['ms']:.4f} ms, plain {norm17[0]['plain_ms']:.4f} ms, library {norm17[0]['library_ms']:.4f} "
            f"ms, bound {norm17[0]['bound_ms']:.4f} ms; backward kernel {norm17[1]['ms']:.4f} ms, plain "
            f"{norm17[1]['plain_ms']:.4f} ms, library {norm17[1]['library_ms']:.4f} ms, bound "
            f"{norm17[1]['bound_ms']:.4f} ms; regimes {regimes17}; card {smi}")

        # 17.3-17.6: training, TTAEngine.evaluate, serving, the f32 step
        served = transformer_train_and_serve(dev, name, os.path.join(tr_root, name), reset_counts=reset_counts,
                                             read_counts=read_counts, per_forward=per_fwd17)
        tr17 = served["train"]
        add_tr(tr17["launches"])
        log(f"[transformer] {name} training (HECKTOR21 recipe: adam 1e-5 poly, batch {tr17['batch']}, remat, "
            f"{tr17['recompute']} norms recomputed a backward) 2 epochs of {TRANSFORMER_TRAIN_VOLUMES} volumes + "
            f"validation of {TRANSFORMER_VAL_VOLUMES}: wall {tr17['wall_s']:.2f} s; losses "
            f"{[round(v, 5) for v in tr17['losses']]}; step ms {[round(t, 1) for t in tr17['step_ms']]}; launches per "
            f"step {tr17['step_launches']} (derived {tr17['step_want']}); over the run {tr17['launches']} (derived "
            f"{tr17['want']}); validation EDT {tr17['edt']}; peak allocated {tr17['peak_gib']:.2f} GiB; validation "
            f"{tr17['val']}; card {smi}")
        log(f"[transformer] {name} warm training steps on device batches: "
            f"{[round(t, 1) for t in tr17['warm_step_ms']]} ms -> median {tr17['median_step_ms']:.2f} ms, "
            f"{tr17['volumes_per_s']:.3f} volumes/s, peak allocated {tr17['warm_peak_gib']:.2f} GiB; card {smi}")
        for tag, r in served["tta"].items():
            add_tr(r["launches"])
            m_ = r["metrics"]
            log(f"[transformer] {name} evaluate {tag}: ms per batch {[round(t, 1) for t in r['ms_per_batch']]}; "
                f"launches {r['launches']} (derived {r['want']}); avg_dc {m_['avg_dc']:.5f} hd95 "
                f"{m_['gtvt_hd95']:.3f} loss {m_['loss']:.5f}; entropy {r['traces']}; card {smi}")
        for proto, r in served["serving"].items():
            add_tr(r["launches"])
            log(f"[transformer] {name} serving {proto}: ms per step {[round(t, 1) for t in r['ms_per_step']]}, "
                f"{r['volumes_per_s']:.3f} volumes/s; launches {r['launches']} (derived {r['want']}); gradient in "
                f"{r['grad_reached']}/{r['norm_tensors']} norm tensors; entropy {r['entropy']}; card {smi}")
        f32 = served["f32_step"]
        log(f"[transformer-parity] {name} f32 Tent step {f32['input']}, kernel vs plain norm: entropy rel "
            f"{f32['entropy_rel']:.3g} (limit 1e-4), norm-delta rel {f32['delta_rel']:.3g} (limit 1e-3), predictions "
            f"agree {f32['predictions_agree']:.6f} (limit 0.999)")
        rec17.update(train=tr17, tta=served["tta"], serving=served["serving"], f32_step=f32)
        del served
        torch.cuda.empty_cache()

        # 17.7: cli.train, cli.adapt and cli.predict with model=<name> on phase 14's fixture
        tcli = transformer_cli(dev, name, cli["manifest"], os.path.join(tr_root, "cli"), reset_counts=reset_counts,
                               read_counts=read_counts, per_forward=per_fwd17)
        for call in ("train", "adapt", "predict"):
            add_tr(tcli[call]["launches"])
            log(f"[transformer] {name} cli.{call}: {tcli[call]['wall_s']:.2f} s, launches {tcli[call]['launches']} "
                f"(derived {tcli[call]['want']}); " + (
                    f"{tcli['train']['steps']} steps, losses {tcli['train']['losses']}, validation "
                    f"{tcli['train']['val']}" if call == "train" else f"metrics {tcli['adapt']['metrics']}"
                    if call == "adapt" else f"{tcli['predict']['cases']} cases, foreground voxels "
                    f"{tcli['predict']['voxels']}")
                + f"; card {smi}")
        rec17["cli"] = tcli
        shutil.rmtree(tr_root, ignore_errors=True)
        torch.cuda.empty_cache()
    del x17
    transformers["launches"] = tr_launches
    transformers["phase_s"] = time.perf_counter() - t_tr
    log(f"[transformer] phase 17 took {transformers['phase_s']:.1f} s; launches {tr_launches}; card {smi}")

    # ---- 18. BatchNorm: the BATCH flagship and the classifiers ------------
    t_bn = time.perf_counter()
    torch.cuda.empty_cache()
    bn_root = os.path.join(REPO, "build", "chip_smoke_batchnorm")  # build/ is in .gitignore
    bn_launches = {"forward": 0, "backward": 0, "minplus": 0}

    def add_bn(counts: dict) -> None:
        for k in bn_launches:
            bn_launches[k] += counts.get(k, 0)

    # 18.1: the flagship with model.norm=BATCH, in process and through the CLIs
    flag = batchnorm_flagship(dev, os.path.join(bn_root, "flagship"), reset_counts=reset_counts,
                              read_counts=read_counts)
    for counts in ([flag["train"]["launches"], flag["norm_step"]["launches"], flag["serving"]["launches"]]
                   + [r["launches"] for r in flag["evaluate"].values()]):
        add_bn(counts)
    tr18 = flag["train"]
    log(f"[batchnorm] BATCH flagship (channels 32..512, bf16, {tr18['params'][0]} param tensors, "
        f"{tr18['params'][1]} BN affines, {BN_NORMS} BatchNorms): training at batch {tr18['batch']} on device "
        f"batches, ms per step {[round(t, 2) for t in tr18['step_ms']]} -> median of the warm {BN_WARM_STEPS} "
        f"{tr18['median_step_ms']:.2f} ms, {tr18['volumes_per_s']:.2f} volumes/s, peak allocated "
        f"{tr18['peak_gib']:.2f} GiB; losses {[round(v, 5) for v in tr18['losses']]}; launches {tr18['launches']}; "
        f"card {smi}")
    log(f"[batchnorm] remat step vs plain step, running statistics: {flag['remat']}; checkpoint round trip "
        f"bitwise {flag['checkpoint_bitwise']}; one norm step: {flag['norm_step']} (limit {BN_STATS_REL} vs f64 "
        f"on the host)")
    for tag, r in flag["evaluate"].items():
        m_ = r["metrics"]
        log(f"[batchnorm] evaluate {tag}: ms per batch {[round(t, 2) for t in r['ms_per_batch']]}; launches "
            f"{r['launches']} (derived {r['want']}); avg_dc {m_['avg_dc']:.5f} hd95 {m_['gtvt_hd95']:.3f} loss "
            f"{m_['loss']:.5f}; entropy {r['traces']}; params and buffers restored {r['unchanged']}; card {smi}")
    log(f"[batchnorm] the evaluated batches' EDT through the kernel and its plain version: {flag['edt']}; "
        f"Tent serving (continual, inline): ms per step {[round(t, 2) for t in flag['serving']['ms_per_step']]}, "
        f"{flag['serving']['volumes_per_s']:.2f} volumes/s, entropy {flag['serving']['entropy']}, launches "
        f"{flag['serving']['launches']}; card {smi}")
    bcli18 = batchnorm_cli(dev, cli["manifest"], os.path.join(bn_root, "cli"), reset_counts=reset_counts,
                           read_counts=read_counts)
    for call, r in bcli18.items():
        add_bn(r["launches"])
        log(f"[batchnorm] cli.{call.split('_')[0]}{' tta=' + call.split('_', 1)[1] if '_' in call else ''}: "
            f"{r['wall_s']:.2f} s, launches {r['launches']} (derived {r['want']}); "
            + (f"{r['steps']} steps, losses {r['losses']}, checkpoint buffers {r['checkpoint_buffers']}"
               if call == "train" else f"metrics {r['metrics']}") + f"; card {smi}")
    # 18.2: the classifiers
    cls18 = classifier_phase(dev, os.path.join(bn_root, "classifiers"), reset_counts=reset_counts,
                             read_counts=read_counts)
    for tag, r in cls18["resnet50"].items():
        add_bn(r["launches"])
        log(f"[batchnorm] resnet50 {tag}: " + json.dumps({k: v for k, v in r.items() if k != "launches"})
            + f"; launches {r['launches']}; card {smi}")
    for name, r in cls18["families"].items():
        add_bn(r["launches"])
        log(f"[batchnorm] {name} pretrained from a torchvision-named file: {r}; card {smi}")
    log(f"[batchnorm] resnet50 f32 on the card (TF32 off) vs the CPU at batch {cls18['resnet50_vs_cpu']['batch']}: "
        f"rel L2 {cls18['resnet50_vs_cpu']['rel_l2']} (limit {CLS_PARITY_REL_L2}; the affines' deltas "
        f"{CLS_PARITY_DELTA_REL_L2})")
    shutil.rmtree(bn_root, ignore_errors=True)
    if bn_launches["forward"] or bn_launches["backward"] or not bn_launches["minplus"]:
        raise AssertionError(f"phase 18 launches {bn_launches}: no norm kernel, the min-plus kernel per batch")
    batchnorm = {"flagship": flag, "cli": bcli18, "classifiers": cls18, "launches": bn_launches,
                 "phase_s": time.perf_counter() - t_bn, "card": smi}
    log(f"[batchnorm] phase 18 took {batchnorm['phase_s']:.1f} s; launches {bn_launches}; card {smi}")

    # ---- 19. the serving artifact -----------------------------------------
    t_srv = time.perf_counter()
    torch.cuda.empty_cache()
    srv = serving_artifact_phase(dev, os.path.join(REPO, "build", "chip_smoke_serving"), manifest=cli["manifest"],
                                 best=cli["best"], reset_counts=reset_counts, read_counts=read_counts)
    art_launches = {"forward": 0, "backward": 0}

    def add_art(got: dict, want: dict, what: str) -> None:
        if got != {**want, "minplus": 0, "plain_backward": 0}:
            raise AssertionError(f"{what}: launches {got}, derived {want}")
        for k in art_launches:
            art_launches[k] += got[k]

    for tag, r in srv["runs"].items():
        for got in r["launches"]:
            add_art(got, r["want"], f"artifact {tag}")
        filed = (f", save {r['save_s']:.2f} s, load {r['load_s']:.2f} s, {r['bytes']} bytes" if "bytes" in r
                 else " (the program in memory)")
        log(f"[serving] {tag} artifact ({r['mode']}, {'episodic' if r['episodic'] else 'continual'}, {r['steps']} "
            f"step; UNet3D {list(r['arch']['channels'])}): export {r['export_s']:.2f} s{filed}, {r['n_state']} "
            f"state leaves, norm calls in the program "
            f"{r['program_norm_calls']}; {r['batches']} batches: ms per step artifact "
            f"{[round(t, 2) for t in r['art_ms']]} (median of the warm {r['art_median_ms']:.2f}) vs live "
            f"{[round(t, 2) for t in r['live_ms']]} (median {r['live_median_ms']:.2f}); one more call profiled: "
            f"device ms {r['art_device_ms']:.2f} vs {r['live_device_ms']:.2f}, most host time {r['art_host_top']} "
            f"vs {r['live_host_top']}, Python functions by own time {r['art_python_top']} vs "
            f"{r['live_python_top']}; the artifact with the cyclic collector on / off "
            f"{[round(t, 2) for t in r['art_ms_gc_on']]} / {[round(t, 2) for t in r['art_ms_gc_off']]} ms "
            f"({r['gc_tracked_objects']} tracked objects), threads {r['threads']}; launches per call "
            f"{r['launches'][0]} (live {r['live_launches'][0]}); predictions agree {min(r['pred_agree'])}, "
            f"entropy abs err {max(r['ent_abs_err'])}, adapted deltas rel L2 {r['delta_rel_l2']} (norm "
            f"{r['delta_norm']:.3e}), frozen params equal {r['frozen_equal']}; card {smi}")
    fa = srv["forward"]
    for got in fa["launches"]:
        add_art(got, fa["want"], "forward artifact")
    log(f"[serving] forward artifact: export {fa['export_s']:.2f} s, {fa['bytes']} bytes, probabilities vs "
        f"_probs_fn max abs {fa['max_abs_err']}, ms {[round(t, 2) for t in fa['art_ms']]} vs live "
        f"{[round(t, 2) for t in fa['live_ms']]}, launches {fa['launches'][0]}; card {smi}")
    ec, sc = srv["export_cli"], srv["serve_cli"]
    n_served = -(-SERVE_CASES // BATCH)
    add_art(sc["launches"], {"forward": 18 * n_served, "backward": 18 * n_served}, "cli.serve_artifact")
    log(f"[serving] cli.export_serving {ec['wall_s']:.2f} s, {ec['bytes']} bytes, launches {ec['launches']}; "
        f"cli.serve_artifact {sc['cases']} cases in {sc['wall_s']:.2f} s, statuses {sc['statuses']}, masks in the "
        f"source grid {sc['masks_in_source_grid']}, entropy {sc['entropy_final']}, launches {sc['launches']}; "
        f"card {smi}")
    srv.update({"launches": art_launches, "phase_s": time.perf_counter() - t_srv, "card": smi})
    log(f"[serving] phase 19 took {srv['phase_s']:.1f} s; launches through artifacts {art_launches}; card {smi}")

    # ---- 20. the training options: MoE, deep supervision, Adafactor, ------
    # distillation, the profiler and debug_nans
    t_opt = time.perf_counter()
    torch.cuda.empty_cache()
    opt20 = training_options_phase(dev, os.path.join(REPO, "build", "chip_smoke_options"),
                                   os.path.join(teacher_root, "flagship"), reset_counts=reset_counts,
                                   read_counts=read_counts)
    shutil.rmtree(teacher_root, ignore_errors=True)
    opt_launches = {k: sum(r["launches"][k] for r in opt20["runs"].values())
                    for k in ("forward", "backward", "minplus")}
    for tag, r in opt20["runs"].items():
        f32 = r["f32_step"]
        log(f"[options] {tag} ({r['family']}, {r['params']} param tensors, {r['param_count'] / 1e6:.1f}M params, "
            f"{r['optimizer']}): {r['steps']} steps at batch {r['batch']} in {r['wall_s']:.2f} s (run with its f32 "
            f"step {r['run_s']:.1f} s); losses {[round(v, 5) for v in r['losses']]}; ms per step (host loader) "
            f"{[round(t, 2) for t in r['step_ms']]}; warm on device batches {[round(t, 2) for t in r['warm_step_ms']]} "
            f"-> median {r['median_step_ms']:.2f} ms, {r['volumes_per_s']:.2f} volumes/s, peak allocated "
            f"{r['warm_peak_gib']:.2f} GiB ({r['peak_gib']:.2f} GiB in the 2-epoch run), optimizer state "
            f"{r['optimizer_state_bytes']} bytes; launches per step {r['step_launches'][0]} (derived "
            f"{r['step_want']}), over the run {r['launches']}; validation EDT bitwise plain {r['edt_bitwise']}; "
            f"validation {r['val']}; card {smi}")
        if "moe" in r and r["moe"]:
            log(f"[options] {tag} MoE ({r['moe_layers']} layers of {OPTION_EXPERTS} experts) aux per step "
                f"{[[round(a, 5) for a in s['aux']] for s in r['moe']]}, dropped per step "
                f"{[[round(d, 5) for d in s['dropped']] for s in r['moe']]}; top-1 routing alike, bf16 forward "
                f"kernel vs plain norm: {r['bf16_routed_alike']}")
        if "teacher_bitwise_checkpoint" in r:
            log(f"[options] {tag}: the teacher bitwise its checkpoint {r['teacher_bitwise_checkpoint']}")
        if "profile" in r:
            log(f"[options] {tag} profiler trace: {r['profile']}")
        log(f"[options] {tag} f32 step {f32['shape']} kernel vs plain norm: loss {f32['loss']} rel "
            f"{f32['loss_rel']:.3g} (limit {TRAIN_LOSS_REL}), param deltas rel L2 {f32['delta_rel_l2']:.3g} (limit {TRAIN_DELTA_REL}), "
            f"launches {f32['launches']}" + (f", routed alike {f32['routed_alike']}" if "routed_alike" in f32 else ""))
    log(f"[options] debug_nans: {opt20['debug_nans']}")
    opt20.update({"launches": opt_launches, "phase_s": time.perf_counter() - t_opt, "card": smi})
    log(f"[options] phase 20 took {opt20['phase_s']:.1f} s; launches {opt_launches}; card {smi}")

    # ---- 21. preprocessing on the card: raw NIfTI -> training and Tent -----
    t_prep = time.perf_counter()
    torch.cuda.empty_cache()
    prep = preprocess_phase(dev, os.path.join(REPO, "build", "chip_smoke_preprocess"), reset_counts=reset_counts,
                            read_counts=read_counts)
    h21, b21 = prep["hecktor"], prep["brats"]
    log(f"[preprocess] raw HECKTOR21 tree: {h21['cases']} cases (CT {list(PREP_CT[0])} int16 at {list(PREP_CT[1])} "
        f"mm, PET {list(PREP_PT[0])} f32 at {list(PREP_PT[1])} mm, GTVt), {prep['fixture_bytes'] / 2**20:.1f} MiB "
        f"uncompressed, written in {prep['fixture_s']:.2f} s")
    log(f"[preprocess] cli.prepare_hecktor21 on the card: {h21['wall_s']:.2f} s, {h21['cases_per_s']:.3f} cases/s; "
        f"ms per case by part (mean) {({k: round(v, 2) for k, v in h21['mean_part_ms'].items()})}; CT resampled to "
        f"{h21['ct_resampled']}, ROI {h21['roi']}; peak allocated {h21['peak_gib']:.3f} GiB (above what the "
        f"earlier phases hold); kernel launches "
        f"{h21['launches']}; splits {h21['splits']}; card {smi}")
    for pid, ms in h21["part_ms"].items():
        log(f"[preprocess]   {pid}: {({k: round(v, 2) for k, v in ms.items()})}")
    cr = h21["ct_resample"]
    log(f"[preprocess] resample_to_spacing of one CT {cr['input']} -> {cr['output']} (host numpy in and out): ms "
        f"{[round(t, 2) for t in cr['ms']]} -> median {cr['median_ms']:.2f}, {cr['bytes_in_out'] / 2**20:.1f} MiB "
        f"in + out, peak allocated {cr['peak_gib']:.3f} GiB (above what the earlier phases hold); card {smi}")
    cc = h21["cpu_case"]
    log(f"[preprocess] {prep['hecktor']['cases']} cases on the card vs its first case on the CPU: manifest row equal "
        f"{cc['row_equal']}, volumes {cc['volumes']} (labels equal, images within {PREP_LINEAR_REL} of their range); "
        f"CPU ms by part {({k: round(v, 2) for k, v in cc['part_ms'].items()})}")
    log(f"[preprocess] cli.prepare_brats on the card: {b21['cases']} cases {list(PREP_BRATS_SHAPE)} -> "
        f"{list(PREP_BRATS_OUTPUT)} in {b21['wall_s']:.2f} s ({b21['cases_per_s']:.3f} cases/s; the raw tree written "
        f"in {b21['fixture_s']:.2f} s); ms by part {b21['part_ms']}; one case on the CPU "
        f"{({k: round(v, 2) for k, v in b21['cpu_part_ms'].items()})}, volumes card vs CPU {b21['volumes']}")
    if any(h21["launches"].values()):
        raise AssertionError(f"preprocessing launched a kernel: {h21['launches']}")
    for call in ("train", "adapt"):
        r = prep[call]
        log(f"[preprocess] cli.{call} on the prepared manifest: {r['wall_s']:.2f} s, launches {r['launches']} "
            f"(derived {r['want']}); " + (f"{r['steps']} steps, {r['val_batches']} validation batches, losses "
                                          f"{r['losses']}, validation {r['val']}" if call == "train"
                                          else f"target {r['target']}, {r['test_batches']} test batches, metrics "
                                          f"{r['metrics']}") + f"; card {smi}")
        if r["launches"] != {**r["want"], "plain_backward": 0}:
            raise AssertionError(f"phase 21 cli.{call}: launches {r['launches']}, derived {r['want']}")
    log(f"[preprocess] EDTs of the validation and test batches, each bitwise its plain version: {prep['edt']}")
    for name, r in prep["ops"].items():
        log(f"[preprocess] {name} on the card vs the CPU: {r}")
    prep_launches = {k: prep["train"]["launches"][k] + prep["adapt"]["launches"][k]
                     for k in ("forward", "backward", "minplus")}
    prep.update({"launches": prep_launches, "phase_s": time.perf_counter() - t_prep, "card": smi})
    log(f"[preprocess] phase 21 took {prep['phase_s']:.1f} s; launches {prep_launches}; card {smi}")

    # ---- 22. the data axis over ranks: two ranks on the card, torchrun ------
    # (2 steps of the sharded store: the smoke's time leaves room for phases 23-25)
    lane_wait = lane.join()
    starts = {15: t_tta, 16: t_brats, 17: t_tr, 18: t_bn, 19: t_srv, 20: t_opt, 21: t_prep}
    log(f"[cli_lane] the NCCL probe and the torchrun command lines of phases 22-24 took {lane.wall_s:.1f} s "
        f"({ {k: round(v, 1) for k, v in lane.seconds.items()} }) beside phases "
        f"{[p for p, t in starts.items() if t < lane.t0 + lane.wall_s]}; phase 22 waited {lane_wait:.1f} s for them")
    # the rank side of phases 22-24 in one spawn of two ranks, then each phase's
    # one-process run and checks
    torch.cuda.empty_cache()
    pairs = [data_parallel_prepare(dev, os.path.join(REPO, "build", "chip_smoke_dp"), volumes=2 * TRAIN_BATCH,
                                   probe=lane.result("nccl_probe")),
             space_parallel_prepare(dev, os.path.join(REPO, "build", "chip_smoke_sp")),
             space_adapters_prepare(dev, os.path.join(REPO, "build", "chip_smoke_sa")),
             space_transformers_prepare(dev, os.path.join(REPO, "build", "chip_smoke_st")),
             adapters_prepare(dev, os.path.join(REPO, "build", "chip_smoke_ad")),
             space_classifiers_prepare(dev, os.path.join(REPO, "build", "chip_smoke_sc"))]
    pairs_s = spawn_pairs(pairs)
    log(f"[pairs] the two ranks of phases 22-24 took {pairs_s:.1f} s, one start-up for the {len(pairs)} jobs")
    dp = data_parallel_finish(pairs[0])
    dp["torchrun"] = lane.result("data_parallel")
    dp["card"] = smi
    log_data_parallel(dp, smi)
    dp_launches = dp["launches"]

    # ---- 23. the space axis over ranks: two ranks on the card, torchrun -----
    torch.cuda.empty_cache()
    sp23 = space_parallel_finish(pairs[1])
    sp23["torchrun"] = lane.result("space_parallel")
    sp23["card"] = smi
    torch.cuda.empty_cache()
    sp23["table"] = split_kernel_table(dev, split_norm_shapes(TRAIN_BATCH, SHAPE[:3], (32, 64, 128, 256, 512),
                                                              (2, 2, 2, 2)))
    if not sp23["table"]["ok"]:
        raise AssertionError(f"phase 23 split kernels vs plain at the path shapes: {sp23['table']['per_shape']}")
    log_space_parallel(sp23, smi)
    sp_launches = sp23["launches"]
    sm_launches = sp23["models_launches"]
    # the slice's cases: every adapter, Tent's windows, flip TTA and the
    # sliding window over the space axis; cli.predict over it vs one process
    torch.cuda.empty_cache()
    sa23 = space_adapters_finish(pairs[2])
    sa23["torchrun"] = sp_predict_check(os.path.join(lane_root, "sp"), sp23["torchrun"])
    sa23["card"] = smi
    log_space_adapters(sa23, smi)
    log(f"[space_adapters] cli.predict over space=2 under torchrun vs one process: "
        f"{json.dumps(sa23['torchrun']['predict_compare'])}; walls {sa23['torchrun']['predict']['wall_s']:.1f} s "
        f"(two ranks) / {sa23['torchrun']['predict_one']['wall_s']:.1f} s (one process); card {smi}")
    sa_launches = sa23["launches"]
    # UNETR and SwinUNETR over the split depth; the sequence axis
    torch.cuda.empty_cache()
    st23 = space_transformers_finish(pairs[3])
    st23["card"] = smi
    log_space_transformers(st23, smi)
    st_launches = st23["launches"]
    # ResNet, DenseNet and EfficientNet over a split image height
    torch.cuda.empty_cache()
    sc23 = space_classifiers_finish(pairs[5])
    sc23["card"] = smi
    log_space_classifiers(sc23, smi)
    sc_launches = sc23["launches"]

    # ---- 24. every adapter over the data axis: two ranks, torchrun CLIs ----
    torch.cuda.empty_cache()
    ad24 = adapters_finish(pairs[4])
    ad24["torchrun"] = ad_predict_check(cli["manifest"], os.path.join(lane_root, "ad"), lane.result("adapters"))
    shutil.rmtree(cli_root, ignore_errors=True)  # phase 14's fixture: phases 15, 17-19 and 22-24 ran on it
    shutil.rmtree(lane_root, ignore_errors=True)
    ad24["card"] = smi
    log_adapters(ad24, smi)
    ad_launches = ad24["launches"]

    # ---- 25-27. the model, expert and stage axes: four ranks, one spawn ------
    # (each phase's one process first, then the ranks of all three in turn)
    axes_root = os.path.join(REPO, "build", "chip_smoke_axes")
    preps = {}
    for name, prepare in (("model_axis", model_axis_prepare), ("expert_axis", expert_axis_prepare),
                          ("stage_axis", stage_axis_prepare)):
        torch.cuda.empty_cache()
        preps[name] = prepare(dev, os.path.join(axes_root, name))
    torch.cuda.empty_cache()  # phase 27b's pipelined case compares with phase 27's sequential run
    preps["space_axes"] = space_axes_prepare(dev, os.path.join(axes_root, "space_axes"),
                                             pipeline=preps["stage_axis"]["spec"])
    torch.cuda.empty_cache()
    axes_s = spawn_axes(dev, [(name, p["spec"]) for name, p in preps.items()], os.path.join(axes_root, "store"))
    log(f"[axes] the four ranks of phases 25-27b took {axes_s:.1f} s, one start-up for the {len(preps)} jobs")
    tp25 = model_axis_compare(dev, preps["model_axis"])
    tp25["card"] = smi
    log_model_axis(tp25, smi)
    tp_launches = dict(tp25["launches"], minplus=0)
    ep26 = expert_axis_compare(dev, preps["expert_axis"])
    ep26["card"] = smi
    log_expert_axis(ep26, smi)
    ep_launches = ep26["launches"]
    sx27 = space_axes_compare(dev, preps["space_axes"])  # before phase 27's compare removes its sequential run
    sx27["card"] = smi
    log_space_axes(sx27, smi)
    sx_launches = sx27["launches"]
    pp27 = stage_axis_compare(dev, preps["stage_axis"])
    pp27.update(card=smi, axes_s=axes_s)
    log_stage_axis(pp27, smi)
    shutil.rmtree(axes_root, ignore_errors=True)


    def norm_summary(name: str, tot: dict, train_tot: dict, brats_tot: dict, n_launches: dict, err: float,
                     extra: dict, direction: str) -> dict:
        return {
            "name": name,
            "route": "cuda",
            "source": "multimodal_tta_tpu_torch/csrc/fused_instance_norm.cu",
            "replaces": "multimodal_tta_tpu/pallas/fused_instance_norm.py:87",
            "launches": sum(n_launches.values()),
            "launches_by_path": n_launches,
            "max_abs_err": err,
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"],
            "per": f"one bf16 forward's {len(shapes)} norm calls at batch {BATCH}",
            "train_step_batch8": {k: train_tot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "brats_forward_batch2": {k: brats_tot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            **{f"{tname}_forward_batch2": {k: transformers[tname]["norm"][direction][k]
                                           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
               for tname in TRANSFORMERS},
            "card": smi,
            **extra,
        }

    summary = norm_summary("fused_instance_norm", totals, norm_totals[TRAIN_BATCH][0], brats_norm[0],
                           {**launches, **norm_eval_launches, "train": train_launches["forward"],
                            "cli": cli_launches["forward"], "tta": tta_launches["forward"],
                            "brats": brats_launches["forward"], "transformer": tr_launches["forward"],
                            "batchnorm": bn_launches["forward"], "serving_artifact": art_launches["forward"],
                            "training_options": opt_launches["forward"], "preprocess": prep_launches["forward"],
                            "data_parallel": dp_launches["forward"], "space_parallel": sp_launches["forward"],
                            "space_models": sm_launches["forward"], "space_adapters": sa_launches["forward"],
                            "space_transformers": st_launches["forward"], "adapters": ad_launches["forward"],
                            "model_axis": tp_launches["forward"], "expert_axis": ep_launches["forward"],
                            "space_axes": sx_launches["forward"], "space_classifiers": sc_launches["forward"]},
                           max_abs_err, {}, "forward")
    backward_summary = norm_summary(
        "fused_instance_norm_backward", btotals, norm_totals[TRAIN_BATCH][1], brats_norm[1],
        {**backward_launches, "train": train_launches["backward"], "cli": cli_launches["backward"],
         "tta": tta_launches["backward"], "brats": brats_launches["backward"],
         "transformer": tr_launches["backward"], "batchnorm": bn_launches["backward"],
         "serving_artifact": art_launches["backward"], "training_options": opt_launches["backward"],
         "preprocess": prep_launches["backward"], "data_parallel": dp_launches["backward"],
         "space_parallel": sp_launches["backward"], "space_models": sm_launches["backward"],
         "space_adapters": sa_launches["backward"], "space_transformers": st_launches["backward"],
         "adapters": ad_launches["backward"],
         "model_axis": tp_launches["backward"], "expert_axis": ep_launches["backward"],
         "space_axes": sx_launches["backward"], "space_classifiers": sc_launches["backward"]}, backward_err,
        {"note": "the gradient of the TPU kernel's function; dx computed in all 18 timed calls"}, "backward")
    minplus_summary = {
        "name": "minplus",
        "route": "cuda",
        "source": "multimodal_tta_tpu_torch/csrc/edt_minplus.cu",
        "replaces": "multimodal_tta_tpu/pallas/edt_minplus.py:52",
        "launches": sum(eval_launches.values()) + train_launches["minplus"] + cli_launches["minplus"]
        + tta_launches["minplus"] + brats_launches["minplus"] + tr_launches["minplus"] + bn_launches["minplus"]
        + opt_launches["minplus"] + prep_launches["minplus"] + dp_launches["minplus"] + sp_launches["minplus"]
        + sm_launches["minplus"] + sa_launches["minplus"] + st_launches["minplus"] + ad_launches["minplus"]
        + ep_launches["minplus"] + sx_launches["minplus"] + sc_launches["minplus"],
        "launches_by_path": {**eval_launches, "train": train_launches["minplus"], "cli": cli_launches["minplus"],
                             "tta": tta_launches["minplus"], "brats": brats_launches["minplus"],
                             "transformer": tr_launches["minplus"], "batchnorm": bn_launches["minplus"],
                             "training_options": opt_launches["minplus"], "preprocess": prep_launches["minplus"],
                             "data_parallel": dp_launches["minplus"], "space_parallel": sp_launches["minplus"],
                             "space_models": sm_launches["minplus"], "space_adapters": sa_launches["minplus"],
                             "space_transformers": st_launches["minplus"], "adapters": ad_launches["minplus"],
                             "expert_axis": ep_launches["minplus"], "space_axes": sx_launches["minplus"],
                             "space_classifiers": sc_launches["minplus"]},
        "max_abs_err": minplus_err,
        "ms": edt_ms,
        "plain_ms": edt_plain_ms,
        "bound_ms": max(t_o, t_b),
        "bound_by": "operations" if t_o >= t_b else "bytes",
        "library_ms": None,
        "per": f"one evaluated batch of {BATCH} volumes, 1 region: the squared EDT of {n_vol} surfaces "
               f"with the root, one launch",
        "probe_add_min_tera_per_s": probe[0],
        "probe_add_min3_tera_per_s": probe[1],
        "bound_at_probe_rate_ms": edt_ops / probe[1] / 1e9,
        "general_minplus_per_call": general,
        "brats_batch2": {k: brats["edt"][k] for k in ("surfaces", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "bound_at_probe_rate_ms")},
        "card": smi,
    }
    log(json.dumps({"serving": serving, "forward_ms": fwd_ms, "forward_plain_norm_ms": fwd_plain_ms,
                    "eval_ms_per_batch": eval_ms, "eval_warm_ms_per_batch": eval_warm_ms,
                    "eval_batch_split_ms": split,
                    "eval_metrics": eval_runs, "training": training, "cli": cli, "tta": tta_log, "brats": brats,
                    "transformers": transformers, "batchnorm": batchnorm, "serving_artifact": srv,
                    "training_options": opt20, "preprocess": prep, "data_parallel": dp, "space_parallel": sp23,
                    "space_adapters": sa23, "space_transformers": st23, "space_classifiers": sc23,
                    "adapters": ad24, "model_axis": tp25,
                    "expert_axis": ep26, "space_axes": sx27, "stage_axis": pp27},
                   default=str))
    log(json.dumps({"kernels": [summary, backward_summary, minplus_summary]
                    + split_summaries(sp23, smi, sa23, st23, sx27, sc23)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_commands()  # a failed phase leaves no command line of the lane running
