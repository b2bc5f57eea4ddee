#!/usr/bin/env python3
"""Where the time of the port's Tent serving step, of one evaluated batch, or
of one training step goes on one CUDA card.

    python3 scripts/torch_serving_profile.py [--protocol online|strict|eval|train|forward] [--batch 2] [--steps 3]
        [--model unet|midfusion|unetr|swin_unetr|resnet50] [--remat] [--norm INSTANCE|BATCH] [--artifact]
        [--moe-experts 8] [--deep-supervision 2]

Builds the flagship UNet3D (channels 32..512, bf16, random weights from a
seed) as chip_smoke.py does, on HECKTOR21 batches; with ``--model
midfusion`` the BraTS mid-fusion UNet (channels 32..512, bf16, remat) on
synthetic BraTS batches [B,160,192,160,4] with the recipe of train_brats.sh
(chip_smoke.py's ``brats_overrides``: adam 1e-4, multi-label DiceCE,
modality dropout in training, threshold 0.5); with ``--model unetr`` or
``--model swin_unetr`` that transformer at the paper widths of
configs/model/<name>.yaml (bf16, chip_smoke.py's phase 17) on the HECKTOR21
batches, ``--remat`` rematerializing it as ``training.remat=true`` does;
``--norm BATCH`` builds the flagship with BatchNorm (``model.norm=BATCH``);
``--moe-experts N`` gives the flagship its bottleneck MoE, or UNETR N
experts in every second encoder block (``model.moe_experts``; in ``train``
the Switch aux loss joins the loss), and ``--deep-supervision K`` gives the
flagship K deep-supervision heads and their loss (``model.deep_supervision``;
chip_smoke.py's phase 20 trains all of these);
``--model resnet50`` is ResNet-50 through ``classifier_logits_apply`` (bf16,
1000 classes) on [B,224,224,3] in Tent's ImageNet-C setting (SGD 2.5e-4,
momentum 0.9, softmax, entropy over all samples; ``online`` and
``strict`` only; run it with ``--batch 64``).
``online`` and ``strict`` profile the Tent
adapt+segment serving step (with ``--artifact`` the serving artifact of that
step, ``serving/export.py``: exported on the card, saved, loaded, and called
with the state it returns, or its initial state in strict mode); ``eval`` profiles the evaluation step of one
batch (forward, Dice/IoU, loss, HD95/ASD/NSD) on synthetic volumes with
ellipsoid labels; ``train`` profiles ``SegTrainer.run_step`` with the
HECKTOR21 training recipe of chip_smoke.py (``train_recipe``: adam, DiceCE,
bf16) on a device-resident batch with ellipsoid labels (run it with
``--batch 8``, the recipe's batch); ``forward`` profiles one no-grad
forward. The step is warmed up, timed over ten
steps without the profiler (and once more without a synchronise, for the
host's share), then ``--steps`` steps run under ``torch.profiler``. Prints:
the wall time per step, the device time by kernel (top 20), the device time
by kind (the fused-InstanceNorm CUDA kernels, forward and backward apart,
convolutions, matmuls (cuBLAS), softmax, LayerNorm, the min-plus CUDA
kernel, the optimizer's foreach kernels, sorts, copies, PyTorch's generic
reduction and elementwise kernels (where a BatchNorm's time goes, with the
loss's and the optimizer-free arithmetic), the rest), the kernels launched per step in all and per kind
(``direct_copy`` kernels on a line of their own, with the calls that launch
them), and the device busy share (summed kernel time over the profiled wall
time). The last line is one JSON object with the same
numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NORM_FORWARD_KERNELS = ("in_fwd_resident", "in_fwd_stream")
NORM_BACKWARD_KERNELS = ("in_bwd_resident", "in_bwd_stream")
CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop", "nhwc")
CONV_ONLY_MARKS = ("conv", "implicit", "dgrad", "wgrad", "fprop")  # a gemm kernel of cuDNN's, not cuBLAS's


SORT_MARKS = ("sort", "radix")
OPTIMIZER_MARKS = ("multi_tensor_apply", "adam")  # torch.optim's foreach kernels
COPY_MARKS = ("memcpy", "copy_kernel", "direct_copy", "memset")


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in NORM_FORWARD_KERNELS):
        return "norm_forward"
    if any(k in low for k in NORM_BACKWARD_KERNELS):
        return "norm_backward"
    if "minplus_edt_kernel" in low or "minplus_matrix_kernel" in low:
        return "minplus_cuda"
    if any(k in low for k in OPTIMIZER_MARKS):
        return "optimizer"
    if any(k in low for k in SORT_MARKS):
        return "sort"
    if any(k in low for k in COPY_MARKS):
        return "copy"
    if "softmax" in low:
        return "softmax"
    if "layer_norm" in low or "layernorm" in low:
        return "layer_norm"
    if ("gemm" in low or "nvjet" in low) and not any(k in low for k in CONV_ONLY_MARKS):
        return "matmul"
    if any(k in low for k in CONV_MARKS):
        return "convolution"
    if "reduce_kernel" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def ellipsoid_labels(torch, dev, batch: int):
    """uint8 labels [batch, 48, 144, 144, 1] with one ellipsoid each, on the card."""
    import numpy as np

    from chip_smoke import SHAPE

    rng = np.random.RandomState(7)
    zz, yy, xx = np.meshgrid(*(np.arange(n) for n in SHAPE[:3]), indexing="ij")
    label = np.stack([
        ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + ((xx - c[2]) / r[2]) ** 2 <= 1.0
        for c, r in ((rng.uniform((16, 50, 50), (32, 94, 94)), rng.uniform((4, 10, 10), (10, 30, 30)))
                     for _ in range(batch))])[..., None]
    return torch.from_numpy(label.astype(np.uint8)).to(dev)


def brats_config():
    from chip_smoke import REPO, brats_overrides
    from multimodal_tta_tpu_torch.conf import compose

    return compose(os.path.join(REPO, "configs"), "config", brats_overrides())


def eval_step_fn(torch, dev, model, batch: int, label=None):
    """The evaluation step on one synthetic batch, as chip_smoke.py
    configures it: ``step(model, x, batch)``-shaped like the serving step."""
    from chip_smoke import eval_config
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy

    if label is None:
        strategy = SegmentationEvaluationStrategy(ConfigNode(eval_config("none", True)))
        label = ellipsoid_labels(torch, dev, batch)
    else:
        strategy = SegmentationEvaluationStrategy(brats_config())

    def step(model, x, n_valid):
        return strategy._to_host(strategy._eval_step(model, x, label))

    return step


def train_step_fn(torch, dev, model, batch: int, label=None, model_keys=None):
    """``SegTrainer.run_step`` with chip_smoke.py's training recipe on one
    device-resident batch (the loss read one step late, as in training);
    ``model_keys`` join the recipe's model node (the MoE and
    deep-supervision options)."""
    from chip_smoke import DEVICE_TRANSFORM, train_recipe
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.registry import get_dataset_builder

    if label is None:
        recipe = train_recipe("")
        recipe["model"].update(model_keys or {})
        cfg, spec = ConfigNode(recipe), DEVICE_TRANSFORM
        label = ellipsoid_labels(torch, dev, batch)
    else:
        cfg = brats_config()
        spec = get_dataset_builder("brats")(cfg).build_transform("train").device_spec()
    trainer = SegTrainer(cfg, device_transform=spec, device=dev)
    trainer.setup(TrainState(model=model, optimizer=build_optimizer(cfg.training, model)[0]))

    def step(model, x, n_valid):
        return trainer.run_step({"image": x, "label": label, "_n_valid": n_valid})

    return step


def artifact_step_fn(torch, dev, adapter, model, shape, threshold, mode):
    """The Tent step as a loaded serving artifact, called as a runtime calls
    it: the state it returned (continual) or its initial state (episodic);
    n_valid and the floor as device tensors made once."""
    from multimodal_tta_tpu_torch.serving import export_adapt_serving, load_artifact, save_artifact

    program, meta, state0 = export_adapt_serving(adapter, model, shape, threshold=threshold, predict_mode=mode)
    path = os.path.join(REPO, "build", "profile_artifact.mttap")  # build/ is in .gitignore
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_artifact(path, program, meta, state0)
    art = load_artifact(path)
    os.remove(path)
    held = {"state": art.initial_state()}
    initial, episodic = list(held["state"]), meta["episodic"]
    n_valid = torch.tensor(shape[0], dtype=torch.int32, device=dev)
    floor = torch.tensor(float("nan"), device=dev)

    def step(model, x, _n):
        out = art.call(*(initial if episodic else held["state"]), x, n_valid, floor)
        if not episodic:
            held["state"] = list(out[:art.n_state])
        return out

    return step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=("online", "strict", "eval", "train", "forward"), default="online")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", choices=("unet", "midfusion", "unetr", "swin_unetr", "resnet50"), default="unet")
    ap.add_argument("--remat", action="store_true", help="rematerialize a transformer (training.remat=true)")
    ap.add_argument("--norm", choices=("INSTANCE", "BATCH"), default="INSTANCE", help="the flagship's norm")
    ap.add_argument("--artifact", action="store_true",
                    help="online/strict: profile the exported serving step instead of the live one")
    ap.add_argument("--moe-experts", type=int, default=0, help="unet/unetr: model.moe_experts")
    ap.add_argument("--deep-supervision", type=int, default=0, help="unet: model.deep_supervision")
    args = ap.parse_args()
    options = {k: v for k, v in (("moe_experts", args.moe_experts), ("deep_supervision", args.deep_supervision)) if v}
    if options and args.model not in ("unet", "unetr") or (args.deep_supervision and args.model != "unet"):
        raise SystemExit("--moe-experts takes --model unet or unetr, --deep-supervision --model unet")

    import torch

    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import DEVICE_TRANSFORM, SHAPE, THRESHOLD
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    online = args.protocol == "online"
    cfg = ConfigNode({"training": {"criterion": {"sigmoid": True}},
                      "tta": {"steps": 1, "lr": 1e-3, "momentum": 0.9, "episodic": not online}})
    if args.model == "midfusion":
        import numpy as np

        from chip_smoke import BRATS_SHAPE, BRATS_THRESHOLD
        from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
        from multimodal_tta_tpu_torch.models import MultimodalUNetMidFusion

        model = MultimodalUNetMidFusion(dtype=torch.bfloat16, remat=True, device=dev, seed=0)
        vols = brats_volumes(args.batch, BRATS_SHAPE, seed=40)
        x = torch.from_numpy(np.stack([v["image"] for v in vols])).to(dev)
        label = torch.from_numpy(np.stack([v["label"] for v in vols])).to(dev, torch.uint8)
        transform, threshold = {"normalize": False}, BRATS_THRESHOLD
    elif args.model in ("unetr", "swin_unetr"):
        from chip_smoke import transformer_overrides
        from multimodal_tta_tpu_torch.conf import compose
        from multimodal_tta_tpu_torch.registry import get_model

        mcfg = compose(os.path.join(REPO, "configs"), "config", transformer_overrides(args.model)).model
        model = get_model(args.model).from_config(mcfg, dtype=torch.bfloat16, remat=args.remat,
                                                  image_size=SHAPE[:3], device=dev, seed=0, **options)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((args.batch,) + SHAPE, generator=gen, device=dev) * 100
        label, transform, threshold = None, DEVICE_TRANSFORM, THRESHOLD
    elif args.model == "resnet50":
        from multimodal_tta_tpu_torch.registry import get_model
        from multimodal_tta_tpu_torch.tta import classifier_logits_apply

        if args.protocol not in ("online", "strict"):
            raise SystemExit("--model resnet50 profiles the Tent step only (--protocol online|strict)")
        cfg = ConfigNode({"training": {"criterion": {"softmax": True, "sigmoid": False}},
                          "tta": {"steps": 1, "lr": 2.5e-4, "momentum": 0.9, "episodic": not online,
                                  "entropy_focus": "all"}})
        model = classifier_logits_apply(get_model("resnet50").from_config(
            ConfigNode({"name": "resnet50", "num_classes": 1000}), dtype=torch.bfloat16, device=dev, seed=0))
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev) * 1.5 + 0.3
        label, transform, threshold = None, None, 0.5
    else:
        model = UNet3D(channels=(32, 64, 128, 256, 512), norm=args.norm, dtype=torch.bfloat16, device=dev, seed=0,
                       **options)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((args.batch,) + SHAPE, generator=gen, device=dev) * 100
        label, transform, threshold = None, DEVICE_TRANSFORM, THRESHOLD
    if args.protocol == "eval":
        step = eval_step_fn(torch, dev, model, args.batch, label)
    elif args.protocol == "train":
        step = train_step_fn(torch, dev, model, args.batch, label, options)
    elif args.protocol == "forward":
        def step(model, x, n_valid):
            with torch.no_grad():
                return model(x)
    else:
        adapter = TentAdapter(cfg.tta, config=cfg, device_transform=transform, device=dev)
        mode = "inline" if online else "post"
        if args.artifact:
            step = artifact_step_fn(torch, dev, adapter, model, tuple(x.shape), threshold, mode)
        else:
            step = adapter.make_adapt_predict_fn(model, threshold=threshold, predict_mode=mode)
    if args.artifact and args.protocol not in ("online", "strict"):
        raise SystemExit("--artifact profiles the serving step only (--protocol online|strict)")
    for _ in range(3):
        step(model, x, args.batch)
    torch.cuda.synchronize()
    # ten more warm steps without the profiler: the step's own time, and how
    # long the host alone needs to enqueue it (no synchronise inside the loop)
    warm_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(model, x, args.batch)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(10):
        step(model, x, args.batch)
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(model, x, args.batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    by_kind, n_by_kind = {}, {}
    for name, ms, count in rows:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
        n_by_kind[kind(name)] = n_by_kind.get(kind(name), 0) + count
    per_step = {k: v / args.steps for k, v in by_kind.items()}
    launches_per_step = {k: v / args.steps for k, v in n_by_kind.items()}
    direct_copies = sum(c for name, _, c in rows if "direct_copy" in name) / args.steps
    # which host calls launch the direct_copy kernels: the operator events
    # named like a copy, by their call count
    copy_ops = {ev.key: ev.count / args.steps for ev in prof.key_averages()
                if ev.key in ("aten::copy_", "aten::contiguous", "aten::clone", "aten::to",
                              "aten::_to_copy", "aten::cat", "aten::pad", "aten::constant_pad_nd")}

    print(f"card: {card}")
    what = f"{args.protocol}{' artifact' if args.artifact else ''}"
    print(f"{what} step without the profiler, 10 warm steps: median "
          f"{sorted(warm_ms)[5]:.3f} ms/step (min {min(warm_ms):.3f}, max {max(warm_ms):.3f}); "
          f"host alone, no synchronise: {host_ms:.3f} ms/step")
    print(f"{what} step, batch {args.batch}, {args.steps} steps: wall {wall_ms / args.steps:.3f} ms/step, "
          f"device {device_ms / args.steps:.3f} ms/step, busy share {device_ms / wall_ms:.3f}")
    for name, ms, count in rows[:20]:
        print(f"  {ms / args.steps:9.3f} ms/step  x{count // args.steps:<4d} {name[:110]}")
    print("by kind (ms/step): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_step.items())))
    print("kernels per step by kind: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(launches_per_step.items()))
          + f"; in all {sum(launches_per_step.values()):.1f}")
    print(f"direct_copy kernels per step: {direct_copies:.1f}; copy-like operator calls per step: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(copy_ops.items())))
    host = sorted(((ev.key, ev.self_cpu_time_total / 1e3 / args.steps, ev.count / args.steps)
                   for ev in prof.key_averages()), key=lambda r: -r[1])[:12]
    print("host time by operator, self ms/step (calls/step): "
          + ", ".join(f"{k} {ms:.2f} ({n:.0f})" for k, ms, n in host))
    print(json.dumps({
        "protocol": args.protocol, "artifact": args.artifact, "model": args.model, "remat": args.remat,
        "norm": args.norm, "batch": args.batch, "options": options,
        "steps": args.steps, "card": card,
        "warm_ms_per_step_no_profiler": warm_ms, "host_enqueue_ms_per_step": host_ms,
        "wall_ms_per_step": wall_ms / args.steps, "device_ms_per_step": device_ms / args.steps,
        "busy_share": device_ms / wall_ms, "device_ms_per_step_by_kind": per_step,
        "kernels_per_step_by_kind": launches_per_step, "direct_copy_kernels_per_step": direct_copies,
        "copy_like_operator_calls_per_step": copy_ops,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
