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
               restored bitwise at the right epoch; one step after the
               restart against the same step without it (strict mode).
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
               loader's); ``cli.adapt`` (Tent, no-adapt report, surface
               metrics) from the best checkpoint; ``cli.predict`` (continual
               Tent, probabilities) writing the 4 test cases: 18 + 18 norm
               launches per training step, one min-plus launch per evaluated
               batch, the launches of each call counted exactly, native NIfTI
               decodes only, masks in their source grid.

Phase 2 also holds the norm kernels against their plain versions at the nine
norm shapes of the batch-8 training step (the largest, [8,48,144,144,32], in
bf16 and f32).

The line before the last is the kernel summary ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Weights and data are random,
made from fixed seeds. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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


def cli_overrides(manifest: str, run_dir: str, *extra: str) -> list:
    """The overrides of every phase-14 CLI call: the full-width recipe of
    configs/ on the fixture, target centre CHUS, 2 validation volumes per
    source centre, 2 epochs with validation (surface metrics on) and a
    checkpoint each epoch."""
    return ["task=hecktor21", "dataset=hecktor21", "model=unet", f"dataset.manifest_csv={manifest}",
            "dataset.target_center=CHUS", "dataset.val_per_center=2", "training.epochs=2",
            "training.model_save_start=0", "training.model_save_freq=1", "training.eval_test.every_n_epochs=1",
            "evaluation.surface.enable=true", f"task.save_dir={os.path.dirname(run_dir)}",
            f"hydra.run.dir={run_dir}", *extra]


def cli_phase(device, root: str, *, shape=CLI_SHAPE, centers=CLI_CENTERS, extra=(),
              reset_counts=lambda: None, read_counts=lambda: {}) -> dict:
    """Phase 14: the port's command-line entry points end to end, as a user
    runs them: write a HECKTOR21 fixture, train (``cli.train``) with the host
    loader and again with ``training.device_cache=true``, adapt with Tent from
    the best checkpoint (``cli.adapt``), export masks (``cli.predict``).

    Checks what holds on any device: the run directories, logs and ``.pt``
    checkpoints; finite losses; the device cache's batches bitwise the host
    loader's (order and f16 / uint8 values); the ``tta_metrics.json`` schema
    and ranges; the model restored after adapt and predict; every case
    exported with its source's grid and mask == prob >= threshold; every
    NIfTI decode on the native path. ``read_counts`` (kernel launch counts,
    zeroed by ``reset_counts`` just before each CLI call) is read per training
    step and after each call; the caller holds them against what the path
    must launch. ``extra`` is appended to every CLI call's overrides."""
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
        for name, args in (("train", ()), ("train_device_cache", ("training.device_cache=true",))):
            history, run_dir, wall, counts = run(train, name, *args)
            m, rec = managers[-1], recorders[-1]
            written = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            want = sorted(f"{n}.{e}" for n in ("best_model", "checkpoint_epoch_0", "checkpoint_epoch_1")
                          for e in ("json", "pt"))
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
                          "val_batches": 2 * len(m.val_loader), "train_volumes": n_train,
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
        source = torch.load(best + ".pt", map_location="cpu", weights_only=True)["model"]

        def restored(m) -> bool:
            return all(torch.equal(v.cpu(), source[k]) for k, v in m.state.model.state_dict().items())

        results, run_dir, wall, counts = run(adapt, "adapt", "tta=tent", "tta.steps=1", "tta.report_no_adapt=true",
                                             f"training.resume={best}")
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
                        "model_restored": restored(managers[-1]),
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
    shutil.rmtree(root, ignore_errors=True)
    return out


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
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

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
    path_norm_shapes = [(BATCH, d0 >> lv, h0 >> lv, w0 >> lv, c)
                        for lv, cs in enumerate(((32,), (32, 64), (64, 128), (128, 256), (256, 512)))
                        for c in cs]
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
    train_norm_shapes = [(TRAIN_BATCH,) + s[1:] for s in path_norm_shapes]
    for shape, dtype in ([(s, torch.bfloat16) for s in train_norm_shapes]
                         + [(train_norm_shapes[0], torch.float32), (train_norm_shapes[-1], torch.float32)]):
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
        log(f"[kernel] training shape {list(shape)} {str(dtype)[6:]} relu ({x.numel() * x.element_size() / 1e6:.1f} MB): "
            f"forward {plan_text(pf)}; backward {plan_text(pb)}; max|kernel-plain| y {err:.3g}, "
            + ", ".join(report) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the norm kernels disagree with plain at the training shape {shape} {dtype}")
        max_abs_err = max(max_abs_err, err)
        backward_err = max(backward_err, float((got[0].float() - ref[0].float()).abs().max()))
        del x, gy, y, stats, got, ref

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
    # one forward's norm calls at the serving batch, then at the training
    # recipe's batch (one training step's 18 forward and 18 backward calls)
    norm_totals = {}
    for batch in (BATCH, TRAIN_BATCH):
        totals, btotals = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
        for (shape, relu), n in counts.items():
            shape = (batch,) + shape[1:]
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

    from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainer_base import HookBase
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.data import HostLoader, get_seg_transforms
    from multimodal_tta_tpu_torch.utils.metrics import set_random_seed

    t_train_phase = time.perf_counter()
    run_root = os.path.join(REPO, "build", "chip_smoke_train")  # build/ is in .gitignore
    shutil.rmtree(run_root, ignore_errors=True)

    def hecktor_volumes(n: int, seed: int) -> list:
        """CT/PET-like volumes [48,144,144,2] with an ellipsoid lesion each."""
        r = np.random.RandomState(seed)
        out = []
        for i in range(n):
            lesion = ellipsoid(r.uniform((14, 40, 40), (34, 104, 104)), r.uniform((3, 8, 8), (8, 24, 24)))
            ct = r.randn(d_, h_, w_).astype(np.float32) * 150.0 - 50.0 + 250.0 * lesion
            ct[r.rand(d_, h_, w_) < 0.3] = -1000.0  # air
            pt = np.abs(r.randn(d_, h_, w_)).astype(np.float32) * 1.5 + 8.0 * lesion
            out.append({"image": np.stack([ct, pt], axis=-1).astype(np.float32),
                        "label": lesion[..., None].astype(np.float32), "domain": ("CHUM", "CHGJ")[i % 2]})
        return out

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
                        for e in ("json", "pt"))
    with open(os.path.join(ckpt_dir, "best_model.json")) as f:
        sidecar = json.load(f)
    log(f"[train] checkpoints written: {written}; best_model.json {sidecar}")
    if written != want_files or sidecar.get("_format") != "torch" or "best_metrics" not in sidecar:
        raise AssertionError(f"checkpoint files {written}, sidecar {sidecar}")

    # a second manager resumes from best_model through training.resume, then
    # loads checkpoint_epoch_1 (written from the state the run ended with)
    run_b = make_manager(os.path.join(run_root, "b"), resume=os.path.join(ckpt_dir, "best_model"))
    got = restored(run_b.trainer, snaps["best_model"])
    resume_epoch = run_b.trainer.start_epoch
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

    # one more step on the same batch, without and after the restart, in
    # strict mode (deterministic cuDNN algorithms, use_deterministic_algorithms)
    step_batch = {"image": np.stack([s["image"] for s in train_set[:TRAIN_BATCH]]),
                  "label": np.stack([s["label"] for s in train_set[:TRAIN_BATCH]])}
    set_random_seed(0, "strict")
    try:
        step_loss = {}
        for tag, run in (("uninterrupted", run_a), ("resumed", run_b)):
            run.trainer.run_step(step_batch)
            step_loss[tag] = run.trainer.flush_step_metrics()["loss"]
        sync()
    finally:
        set_random_seed(0, "practical")
    pa, pb = dict(run_a.model.named_parameters()), dict(run_b.model.named_parameters())
    bitwise = all(torch.equal(pa[n], pb[n]) for n in pa)
    step_rel = max(float((pa[n] - pb[n]).abs().max()) / max(float(pa[n].abs().max()), 1e-30) for n in pa)
    loss_rel = abs(step_loss["resumed"] - step_loss["uninterrupted"]) / abs(step_loss["uninterrupted"])
    log(f"[train] one step after the restart vs without it (strict mode): loss {step_loss}, rel diff "
        f"{loss_rel:.3g} (limit {RESUME_STEP_REL}); params max rel diff {step_rel:.3g} (limit {RESUME_STEP_REL}); "
        f"bitwise equal={bitwise}")
    if not (loss_rel <= RESUME_STEP_REL and step_rel <= RESUME_STEP_REL):
        raise AssertionError("the step after the restart differs from the step without it")
    del run_b, pb

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
    del run_a, trainer, model, dev_batches
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
    cli = cli_phase(dev, os.path.join(REPO, "build", "chip_smoke_cli"),  # build/ is in .gitignore
                    reset_counts=reset_counts, read_counts=read_counts)
    cli_s = time.perf_counter() - t1
    log(f"[cli] fixture: {sum(CLI_CENTERS.values())} HECKTOR21 cases {CLI_SHAPE} (X,Y,Z) over {CLI_CENTERS}, "
        f"{cli['fixture_bytes'] / 2**20:.1f} MiB written in {cli['fixture_s']:.2f} s; g++ build of the native "
        f"decoder {cli['native_build_s']:.2f} s; decode of one CT volume "
        f"{cli['decode_ms_per_volume']['native']:.2f} ms native, {cli['decode_ms_per_volume']['python']:.2f} ms "
        f"Python; decodes by path over the phase {cli['decodes']}")
    for run_name in ("train", "train_device_cache"):
        r = cli[run_name]
        log(f"[cli] {run_name}: {r['train_volumes']} volumes, {r['steps']} steps in {r['wall_s']:.2f} s; ms per step "
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
            f"model restored {r['model_restored']}; " + (
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

    def norm_summary(name: str, tot: dict, train_tot: dict, n_launches: dict, err: float, extra: dict) -> dict:
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
            "card": smi,
            **extra,
        }

    summary = norm_summary("fused_instance_norm", totals, norm_totals[TRAIN_BATCH][0],
                           {**launches, **norm_eval_launches, "train": train_launches["forward"],
                            "cli": cli_launches["forward"]}, max_abs_err, {})
    backward_summary = norm_summary(
        "fused_instance_norm_backward", btotals, norm_totals[TRAIN_BATCH][1],
        {**backward_launches, "train": train_launches["backward"], "cli": cli_launches["backward"]}, backward_err,
        {"note": "the gradient of the TPU kernel's function; dx computed in all 18 timed calls"})
    minplus_summary = {
        "name": "minplus",
        "route": "cuda",
        "source": "multimodal_tta_tpu_torch/csrc/edt_minplus.cu",
        "replaces": "multimodal_tta_tpu/pallas/edt_minplus.py:52",
        "launches": sum(eval_launches.values()) + train_launches["minplus"] + cli_launches["minplus"],
        "launches_by_path": {**eval_launches, "train": train_launches["minplus"], "cli": cli_launches["minplus"]},
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
        "card": smi,
    }
    log(json.dumps({"serving": serving, "forward_ms": fwd_ms, "forward_plain_norm_ms": fwd_plain_ms,
                    "eval_ms_per_batch": eval_ms, "eval_warm_ms_per_batch": eval_warm_ms,
                    "eval_batch_split_ms": split,
                    "eval_metrics": eval_runs, "training": training, "cli": cli}))
    log(json.dumps({"kernels": [summary, backward_summary, minplus_summary]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
