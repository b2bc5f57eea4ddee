#!/usr/bin/env python3
"""chip_smoke.py's phase 23 alone: the space axis over ranks on one CUDA card.

    python3 scripts/torch_space_parallel.py [--kernels] [--no-cli] [--witnesses] [--models] [--adapters]
                                            [--transformers] [--axes] [--classifiers]

Builds the CUDA kernels and holds the four split-depth norm entries
(``stats``, ``apply``, ``bwd_sums``, ``bwd_apply``) against their plain
versions at the split norm shapes of one flagship training forward at batch
8 on one of two space ranks, with their times and byte bounds
(``chip_smoke.split_kernel_table``); with ``--kernels`` that is all. Then
``chip_smoke.space_parallel_phase``: two ranks spawned on card 0
(``training.devices=[0, 0]``, gloo) on a ``data=1 x space=2`` mesh against
one process on the same global batches (the flagship at full width: training,
validation, Tent online and strict, ``TTAEngine.evaluate``; one mid-fusion
training step at BraTS size; the other models, norms and training options
below), each rank's launches exactly, its split
kernels against their plain versions, its peak memory against one process's;
then, unless ``--no-cli``, ``cli.train`` and ``cli.adapt`` under ``python -m
torch.distributed.run --nproc_per_node=2`` with ``training.mesh.space=2`` on
a HECKTOR21 fixture written here at (144,144,48). Prints the card's name and
power limit, the phase's lines, and as the last line one JSON object with
its numbers. Needs a CUDA card.

``--models`` runs the phase without the kernel table and the command
lines, and prints the lines of its other models, norms and training
options (``chip_smoke.sm_run``, ``SM_CASES``): late fusion with remat and
the flagship with deep supervision and 4 bottleneck experts on
[1,160,192,160,4], UNet3D-WS distilled from a flagship teacher, SegResNet,
the BatchNorm flagship and the flagship with GWDL on [2,48,144,144,2],
each over the two ranks against one process (training, Tent, ``norm`` and
evaluated batches as the phase runs them), then each model's bf16 step.

``--adapters`` runs the phase's evaluation and adaptation over a split
depth alone (``chip_smoke.space_adapters_phase``, ``SA_CASES``): pl, eata,
sar, cotta, memo, Tent with windows, evaluation with flip TTA and with the
sliding window, the flagship at full width over the two ranks against one
process, each rank's launches exactly and every kernel call against its
plain version; then, unless ``--no-cli``, ``cli.train``, ``cli.adapt`` and
``cli.predict`` over ``training.mesh.space=2`` under torchrun and
``cli.predict`` in one process from the same checkpoint (each a command
line), their files compared byte for byte (``chip_smoke.sp_predict_check``).

``--transformers`` runs the phase's transformers alone
(``chip_smoke.space_transformers_phase``, ``ST_CASES``): UNETR and
SwinUNETR at ``configs/model/``'s widths on one HECKTOR21 batch of 2 (a
forward, an SGD step, a Tent step, an evaluated batch with the surface
metrics) and UNETR with ``seq_shard_axis=space`` on one BraTS volume (a
forward, an SGD step), f32, the two ranks against one process, each rank's
launches exactly and every kernel call against its plain version.
``--axes`` runs phase 27b alone (``chip_smoke.space_axes_phase``): four
ranks on the card, UNETR with the sequence axis over ``space=2 x model=2``
at BraTS size, the flagship with 4 bottleneck experts over
``space=2 x expert=2``, ViT-B/16 pipelined over ``space=2 x stage=2``
against its own sequential run. ``--classifiers`` runs the phase's CNN
classifiers alone (``chip_smoke.space_classifiers_phase``): ResNet-50 in
Tent's setting (64 x 224 x 224, 1000 classes) through every adapter and
DenseNet-121, EfficientNet-B0 and EfficientNet-V2-S at 16 (a forward, a
Tent step), the two ranks over a split image height against one process,
then ResNet-50's bf16 Tent step timed. Each prints its seconds.

``--witnesses`` (instead of the phase) reads how sensitive phase 23's
mid-fusion step is to the order of its sums, in one process: the gradients
of that f32 step (BraTS size, remat, TF32 off) taken again with cuDNN's
deterministic algorithms (its weight gradients reduced in another order)
and with the plain norm (the statistics summed by torch's reductions
instead of the kernel's), each as a relative L2 from the first; and the
BatchNorm flagship's first step of ``--models`` again with cuDNN's
deterministic algorithms, again with its defaults, and with each BatchNorm
sum taken as the sum of its two depth halves' (the order a split depth
sums in). These are what
``chip_smoke.SP_MID_GRAD_REL`` and ``SM_GRAD_REL`` rest on.
"""

from __future__ import annotations

import argparse
import json
from unittest import mock
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mid_witnesses(dev) -> dict:
    """The first mid-fusion step's gradients three ways (``--witnesses``):
    each variant's relative L2 from the plain run's."""
    import torch

    import chip_smoke
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
    from multimodal_tta_tpu_torch.models.layers import set_plain_norm
    from multimodal_tta_tpu_torch.models.unet_multimodal_midfusion import MultimodalUNetMidFusion

    cfg = ConfigNode({"task": {"seed": 0}, "training": {
        "optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}}, "remat": True,
        "criterion": chip_smoke.MID_CRITERION, "compute_dtype": "float32",
        "param_groups": {"no_decay_keys": ["bias", "norm", "scale"], "treat_1d_as_no_decay": True}}})
    batch = chip_smoke._stack(brats_volumes(chip_smoke.SP_MID_BATCH, tuple(chip_smoke.BRATS_SHAPE), seed=232))

    def grads(deterministic: bool, plain: bool) -> dict:
        torch.backends.cudnn.deterministic = deterministic
        try:
            mid = MultimodalUNetMidFusion(channels=(32, 64, 128, 256, 512), remat=True, device=dev, seed=5)
            set_plain_norm(mid, plain)
            optimizer, lr = build_optimizer(cfg.training, mid, None)
            trainer = SegTrainer(cfg, device_transform={"normalize": False}, device=dev)
            trainer.setup(TrainState(model=mid, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
            trainer.state.apply_gradients = lambda: False
            trainer.run_step({"image": batch["image"], "label": batch["label"]})
            return {n: p.grad.detach().clone() for n, p in mid.named_parameters() if p.grad is not None}
        finally:
            torch.backends.cudnn.deterministic = False

    base = grads(False, False)
    return {key: chip_smoke._grad_rel(grads(det, plain), base)
            for key, det, plain in (("cudnn_deterministic", True, False), ("plain_norm", False, True))}


def bn_witnesses(dev) -> dict:
    """The BatchNorm flagship's first f32 step of phase 23's space models
    (``chip_smoke.sm_run``'s ``batchnorm`` case, one process) on an
    ill-conditioned batch: its gradients again with cuDNN's deterministic
    algorithms, again with the defaults, and with each BatchNorm sum taken
    over two depth halves, each as a relative L2 from the default run's.
    What ``chip_smoke.SM_GRAD_REL["batchnorm"]`` rests on."""
    import torch

    import chip_smoke
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.models import layers
    from multimodal_tta_tpu_torch.registry import get_model

    criterion = chip_smoke.train_recipe(os.path.join(REPO, "build", "witness_recipe"))["training"]["criterion"]
    node = dict(chip_smoke.model_node("unet"), norm="BATCH")
    cfg = ConfigNode(chip_smoke.sm_config(node, criterion, "float32", remat=False))
    # HECKTOR21 volumes of seed SM_SEED: a batch on which two ranks' BN step
    # sits 1.27e-4 from one process's (phase 23's own batch: 2.5e-6)
    vols = chip_smoke.hecktor_volumes(chip_smoke.SM_HECKTOR_VOLUMES, chip_smoke.SM_SEED)
    batch = chip_smoke.sm_batches({"sm_hecktor": vols}, "hecktor")[0]

    stock_sum = torch.Tensor.sum

    def halves(x, *a, **k):
        """``x.sum(dims)`` taken as the sum of its two depth halves' sums
        where the depth (dim 2 of a 5-D tensor) is even and reduced: the
        order a split depth sums in."""
        dims = a[0] if a else k.get("dim")
        if x.dim() == 5 and isinstance(dims, (list, tuple)) and 2 in dims and x.shape[2] % 2 == 0:
            d = x.shape[2] // 2
            return stock_sum(x.narrow(2, 0, d), *a, **k) + stock_sum(x.narrow(2, d, d), *a, **k)
        return stock_sum(x, *a, **k)

    def grads(deterministic: bool, split_sums: bool = False) -> dict:
        torch.backends.cudnn.deterministic = deterministic
        stock = layers.BatchNorm.forward

        def forward(self, x, relu=False):
            with mock.patch.object(torch.Tensor, "sum", halves):
                return stock(self, x, relu)

        try:
            if split_sums:
                layers.BatchNorm.forward = forward
            model = get_model("unet").from_config(cfg.model, device=dev, seed=chip_smoke.SM_SEED)
            optimizer, lr = build_optimizer(cfg.training, model, None)
            trainer = SegTrainer(cfg, device_transform=chip_smoke.DEVICE_TRANSFORM, device=dev)
            trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(cfg.training, lr))
            trainer.state.apply_gradients = lambda: False
            trainer.run_step({"image": batch["image"], "label": batch["label"]})
            return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        finally:
            torch.backends.cudnn.deterministic = False
            layers.BatchNorm.forward = stock

    base = grads(False)
    return {"bn_cudnn_deterministic": chip_smoke._grad_rel(grads(True), base),
            "bn_default_again": chip_smoke._grad_rel(grads(False), base),
            "bn_sums_in_depth_halves": chip_smoke._grad_rel(grads(False, split_sums=True), base)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true", help="only the split entries against their plain versions")
    ap.add_argument("--no-cli", action="store_true", help="skip the torchrun CLI runs")
    ap.add_argument("--witnesses", action="store_true", help="the mid-fusion step's sensitivity to its sums' order")
    ap.add_argument("--models", action="store_true", help="the phase alone, with its other models' lines")
    ap.add_argument("--adapters", action="store_true", help="the phase's adapters, flip TTA and sliding window alone")
    ap.add_argument("--transformers", action="store_true", help="the phase's UNETR, SwinUNETR and sequence axis alone")
    ap.add_argument("--axes", action="store_true", help="phase 27b alone: space beside the model, expert, stage axes")
    ap.add_argument("--classifiers", action="store_true", help="the phase's ResNet, DenseNet, EfficientNet alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_space_parallel: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
    from multimodal_tta_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    built = {src: _build.load(src) for src in ("fused_instance_norm", "edt_minplus")}
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.kernels:  # ptxas -v of the split entries: registers, shared memory, spills
        lines = built["fused_instance_norm"].log.splitlines()
        for i, line in enumerate(lines):
            if "_split" in line:
                print("\n".join(lines[i:i + 3]), flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.witnesses:
        got = dict(mid_witnesses(dev), **bn_witnesses(dev))
        print(f"[witnesses] the mid-fusion step's gradients, relative L2 from the default run: {got}; card {card}")
        print(json.dumps({"witnesses": got, "card": card}))
        return 0
    if args.adapters:
        root = os.path.join(REPO, "build", "space_adapters")  # build/ is in .gitignore
        shutil.rmtree(root, ignore_errors=True)
        sa = chip_smoke.space_adapters_phase(dev, os.path.join(root, "phase"))
        chip_smoke.log_space_adapters(sa, card)
        if not args.no_cli:
            manifest = make_hecktor_fixture(os.path.join(root, "fixture"), shape=chip_smoke.CLI_SHAPE,
                                            centers={"CHUS": 4, "CHUM": 10, "CHGJ": 10})
            cli = chip_smoke.sp_torchrun_cli(manifest, os.path.join(root, "torchrun"))
            sa["torchrun"] = chip_smoke.sp_predict_check(os.path.join(root, "torchrun"), cli)
            print(f"[space_adapters] cli over space=2 vs one process: {json.dumps(sa['torchrun'])}; card {card}",
                  flush=True)
        shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"space_adapters": sa, "card": card}, default=str))
        return 0
    if args.transformers or args.axes or args.classifiers:
        out = {"card": card}
        if args.classifiers:
            t1 = time.perf_counter()
            sc = chip_smoke.space_classifiers_phase(dev, os.path.join(REPO, "build", "space_classifiers"))
            chip_smoke.log_space_classifiers(sc, card)
            out["space_classifiers"] = dict(sc, s=time.perf_counter() - t1)
            print(f"[space_classifiers] the job took {out['space_classifiers']['s']:.1f} s; card {card}", flush=True)
        if args.transformers:
            t1 = time.perf_counter()
            st = chip_smoke.space_transformers_phase(dev, os.path.join(REPO, "build", "space_transformers"))
            chip_smoke.log_space_transformers(st, card)
            out["space_transformers"] = dict(st, s=time.perf_counter() - t1)
            print(f"[space_transformers] the job took {out['space_transformers']['s']:.1f} s; card {card}", flush=True)
        if args.axes:
            t1 = time.perf_counter()
            sx = chip_smoke.space_axes_phase(dev, os.path.join(REPO, "build", "space_axes"))
            chip_smoke.log_space_axes(sx, card)
            out["space_axes"] = dict(sx, s=time.perf_counter() - t1)
            print(f"[space_axes] the job took {out['space_axes']['s']:.1f} s; card {card}", flush=True)
        print(json.dumps(out, default=str))
        return 0
    if args.models:
        sp = chip_smoke.space_parallel_phase(dev, os.path.join(REPO, "build", "space_models"))
        chip_smoke.log_space_parallel(sp, card)
        print(json.dumps({"space_models": {k: sp[k] for k in ("models_compare", "models_launches", "ranks_s",
                                                              "one_s", "phase_s")}, "card": card}, default=str))
        return 0
    shapes = chip_smoke.split_norm_shapes(chip_smoke.TRAIN_BATCH, chip_smoke.SHAPE[:3], (32, 64, 128, 256, 512),
                                          (2, 2, 2, 2))
    table = chip_smoke.split_kernel_table(dev, shapes)
    for row in table["per_shape"]:
        print(f"[split] {row}", flush=True)
    print(f"[split] totals {table['entries']}; ok {table['ok']}; card {card}", flush=True)
    out = {"table": table, "card": card}
    if not args.kernels:
        root = os.path.join(REPO, "build", "space_parallel")  # build/ is in .gitignore
        shutil.rmtree(root, ignore_errors=True)
        manifest = None
        if not args.no_cli:
            manifest = make_hecktor_fixture(os.path.join(root, "fixture"), shape=chip_smoke.CLI_SHAPE,
                                            centers={"CHUS": 4, "CHUM": 10, "CHGJ": 10})
        sp = chip_smoke.space_parallel_phase(dev, os.path.join(root, "phase"))
        if manifest is not None:
            sp["torchrun"] = chip_smoke.sp_torchrun_cli(manifest, os.path.join(root, "torchrun"))
        sp["table"] = table
        chip_smoke.log_space_parallel(sp, card)
        shutil.rmtree(root, ignore_errors=True)
        out["space_parallel"] = sp
    print(json.dumps(out, default=str))
    return 0 if table["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
