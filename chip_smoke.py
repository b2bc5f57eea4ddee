#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, in order (any failure propagates and exits non-zero):
  1. build   — define the Triton kernels from the repository's sources;
               Triton compiles each specialisation at its first launch into
               ``build/triton_cache`` (listed in .gitignore).
  2. kernel  — the fused InstanceNorm kernel against its plain PyTorch
               version at the main path's largest and smallest norm shapes,
               bf16 and f32, ReLU on and off; the autograd backward against
               autograd of the plain version.
  3. forward — the flagship UNet3D at full width (channels 32..512, two
               residual subunits, bf16) on a HECKTOR21 batch [2,48,144,144,2]
               through the kernel; launch count per forward; logits against
               the same weights run through the plain norm.
  4. serving — Tent adapt+segment: 3 batches online (continual, inline
               predictions) and 2 strict (episodic, post-update predictions):
               finite entropy, a gradient in all 36 norm tensors, uint8 predictions
               of the right shape, ms per step and volumes/s.
  5. parity  — one Tent step at full width on a small input, kernel against
               plain norm in f32: entropy, norm-param deltas, predictions.
  6. timing  — the kernel at every norm shape of one forward, against the
               plain version, F.instance_norm+relu and the byte bound.

The line before the last is the kernel summary ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Weights and data are random,
made from fixed seeds. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # non-tensor-core f32
# tolerances of kernel vs plain: f32 — same arithmetic, other summation
# order over up to 1M elements; bf16 — one bf16 rounding step of the output
TOL_F32 = dict(atol=5e-5, rtol=0.0)
TOL_BF16 = dict(atol=5e-2, rtol=2.0 ** -7)
LOGITS_REL_L2 = 1e-2  # full-width bf16 forward, kernel vs plain norm

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
THRESHOLD = 0.3


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton_cache"))
    os.environ.setdefault("TRITON_HOME", os.path.join(REPO, "build", "triton_home"))
    sys.path.insert(0, REPO)

    from multimodal_tta_tpu_torch.kernels import fused_instance_norm_triton
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
        fused_instance_norm,
        instance_norm_plain,
    )
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm, set_plain_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.ops.intensity import make_intensity_normalizer
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask
    from multimodal_tta_tpu_torch.conf import ConfigNode

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
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
    k = fused_instance_norm_triton.build()
    log(f"[build] triton {k.version}: kernels stats/finish/norm defined in "
        f"{time.perf_counter() - t0:.2f}s; cache {os.environ['TRITON_CACHE_DIR']}")

    # ---- 2. kernel vs plain ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs_err = 0.0
    largest = (BATCH, SHAPE[0], SHAPE[1], SHAPE[2], 32)
    smallest = (BATCH, SHAPE[0] // 16, SHAPE[1] // 16, SHAPE[2] // 16, 512)
    for shape in (largest, smallest):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            for act in ("relu", None):
                c = shape[-1]
                x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
                g = torch.rand(c, generator=gen, device=dev) + 0.5
                b = torch.randn(c, generator=gen, device=dev) * 0.1
                t1 = time.perf_counter()
                y = fused_instance_norm(x, g, b, act=act)
                sync()
                first = time.perf_counter() - t1
                err, ok = within(y, instance_norm_plain(x, g, b, act=act), tol)
                log(f"[kernel] {list(shape)} {str(dtype)[6:]} act={act}: max|kernel-plain|={err:.3g} "
                    f"tol atol={tol['atol']} rtol={tol['rtol']:.3g} first call {first:.2f}s "
                    f"{'ok' if ok else 'FAIL'}")
                if not (ok and y.dtype == dtype and y.shape == x.shape):
                    raise AssertionError(f"kernel disagrees with plain at {shape} {dtype} act={act}")
                max_abs_err = max(max_abs_err, err)
    # backward: autograd through the kernel's Function vs autograd of plain
    shape = (BATCH, 12, 36, 36, 64)
    x = torch.randn(shape, generator=gen, device=dev).requires_grad_()
    g = (torch.rand(64, generator=gen, device=dev) + 0.5).requires_grad_()
    b = (torch.randn(64, generator=gen, device=dev) * 0.1).requires_grad_()
    gy = torch.randn(shape, generator=gen, device=dev)
    got = torch.autograd.grad(fused_instance_norm(x, g, b), (x, g, b), gy)
    ref = torch.autograd.grad(instance_norm_plain(x, g, b), (x, g, b), gy)
    for nm, u, v in zip(("dx", "dgamma", "dbeta"), got, ref):
        err = float((u - v).abs().max())
        lim = 1e-4 * float(v.abs().max()) + 1e-5
        log(f"[kernel] backward {list(shape)} f32 {nm}: max err {err:.3g} (limit {lim:.3g})")
        if not err <= lim:
            raise AssertionError(f"backward {nm} disagrees")

    # ---- 3. full-width forward ------------------------------------------
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
        ("online", "inline", False, 3), ("strict", "post", True, 2),
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
        for i in range(n_batches):
            t1 = time.perf_counter()
            state, pred = step(model, batches[i], BATCH)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
            ents.append(adapter.last_entropy)
        launches[proto] = fused_instance_norm.launches
        params = dict(model.named_parameters())
        moved = [n for n in names if bool((params[n] - source[n]).abs().max() > 0)]
        # every norm tensor must get a gradient; a scale at 1.0 stays put when
        # each update is below half an f32 ulp there (lr * |g| < 6e-8)
        reached = [n for n in names if params[n].grad is not None
                   and bool(params[n].grad.abs().max() > 0) and bool(torch.isfinite(params[n].grad).all())]
        still = {n: float(params[n].grad.abs().max()) * 1e-3 for n in names if n not in moved}
        steady = times[1:]
        ms = sum(steady) / len(steady)
        serving[proto] = {"ms_per_step": times, "steady_ms": ms, "volumes_per_s": BATCH * 1e3 / ms,
                          "entropy": ents, "launches": launches[proto], "grad_reached": len(reached),
                          "moved": len(moved)}
        log(f"[serving] {proto} ({'episodic' if episodic else 'continual'}, predict={predict}) "
            f"batch {BATCH}: ms/step {[round(t, 2) for t in times]} -> steady {ms:.2f} ms, "
            f"{BATCH * 1e3 / ms:.2f} volumes/s; entropy {ents}; nonzero gradient in "
            f"{len(reached)}/{len(names)} norm tensors, {len(moved)} moved; pred {list(pred.shape)} "
            f"{pred.dtype}; {launches[proto]} kernel launches ({launches[proto] // n_batches}/step); "
            f"card {smi}")
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

    # ---- 6. kernel timing at every norm shape of one forward --------------
    import torch.nn.functional as F

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
    for (shape, relu), n in counts.items():
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(torch.bfloat16)
        g = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.1
        act = "relu" if relu else None
        err, ok = within(fused_instance_norm(x, g, b, act=act), instance_norm_plain(x, g, b, act=act), TOL_BF16)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at {shape}")
        max_abs_err = max(max_abs_err, err)
        ms = cuda_ms(lambda: fused_instance_norm(x, g, b, act=act))
        plain_ms = cuda_ms(lambda: instance_norm_plain(x, g, b, act=act))
        x_ncdhw = x.permute(0, 4, 1, 2, 3)
        lib_ms = cuda_ms(lambda: F.relu(F.instance_norm(x_ncdhw, weight=g, bias=b, eps=1e-5)))
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4  # read x, write y, gamma, beta
        flops = 8 * x.numel()  # stats: add, mul, add; normalize, affine, relu: 5
        log(f"[timing] {list(shape)} bf16 x{n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.instance_norm+relu {lib_ms:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
            f"max err {err:.3g}")
        totals["ms"] += n * ms
        totals["plain_ms"] += n * plain_ms
        totals["library_ms"] += n * lib_ms
        totals["bytes"] += n * nbytes
        totals["flops"] += n * flops
    t_bytes = totals["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = totals["flops"] / FP32_FLOPS * 1e3
    summary = {
        "name": "fused_instance_norm",
        "route": "triton",
        "source": "multimodal_tta_tpu_torch/kernels/fused_instance_norm_triton.py",
        "replaces": "multimodal_tta_tpu/pallas/fused_instance_norm.py:87",
        "launches": launches["forward"] + launches["online"] + launches["strict"],
        "launches_by_path": launches,
        "max_abs_err": max_abs_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": totals["library_ms"],
        "per": f"one bf16 forward at batch {BATCH}: {len(shapes)} calls",
        "two_pass_bound_ms": 1.5 * t_bytes,
        "card": smi,
    }
    log(json.dumps({"serving": serving, "forward_ms": fwd_ms, "forward_plain_norm_ms": fwd_plain_ms}))
    log(json.dumps({"kernels": [summary]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
