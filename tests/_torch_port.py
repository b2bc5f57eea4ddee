"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``): build a flax module's params from
a seed, carry them to the port, and move arrays across as numpy."""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_tta_tpu_torch.models.convert import flax_path, unet3d_from_flax

# HECKTOR21 on-device transform (mirror of bench.py's DEVICE_TRANSFORM)
HECKTOR_POLICY = {
    "enabled": True,
    "channel_names": ["ct", "pt"],
    "channels": {
        "ct": {"clip": [-1000, 1000], "zscore": {"masked": True, "mask_gt": -900, "eps": 1e-6}},
        "pt": {"clip": [0.0, 15.0], "zscore": {"masked": True, "mask_gt": 0.0, "eps": 1e-6}},
    },
}
DEVICE_TRANSFORM = {"normalize": True, "intensity_policy": HECKTOR_POLICY, "channel_names": ["ct", "pt"]}

# the dryrun UNet3D of the parity tests
DRYRUN = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32, 64),
              strides=(2, 2, 2, 2), num_res_units=2)


def np_params(module, x, seed: int = 0, **call_kw):
    """Init a flax module on ``x`` and return its params as nested numpy."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **call_kw)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def randomize(params, seed: int):
    """Replace every leaf with N(0, 0.3^2) noise, so biases and norm affines
    are not their trivial init values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32), params)


def load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(unet3d_from_flax(params), strict=True)
    return module


def to_ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 4, 1).float().numpy()


# the small UNet3D of the training parity tests: two levels, f32, on
# [B, 8, 16, 16, 2] volumes
SMALL = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=2)
SMALL_SHAPE = (8, 16, 16, 2)


def random_flax_params(module, x_shape, seed: int = 0):
    """Params of a flax module built from its shapes alone (``jax.eval_shape``
    of ``init``, nothing compiled), filled from a numpy seed: lecun-scaled
    kernels, norm scales near 1, small nonzero biases."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def meta_model(name: str, cfg: dict) -> torch.nn.Module:
    """A registry model's structure without storage: its tensors are made on
    the ``meta`` device and the constructor's move to ``device="cpu"``
    (``Module.to``) is skipped, as a meta tensor cannot be copied out."""
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.registry import get_model

    with torch.device("meta"), mock.patch.object(torch.nn.Module, "to", lambda self, *a, **k: self):
        return get_model(name).from_config(ConfigNode(cfg), device="cpu", seed=None)


def flat_flax(tree) -> dict:
    """A flax params-like tree as ``{'/'-joined path: leaf}``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf for path, leaf in leaves}


# ---------------------------------------------------------------------------
# TTA parity: the same weights, batches and random draws through a JAX
# adapter and its port (tests/test_torch_tta_*.py, tests/test_torch_stream.py)

TTA_SEED = 0


def tta_config(method: str = "tent", *, softmax: bool = False, **tta) -> dict:
    """A config dict: the criterion mode, ``task.seed`` and a ``tta`` node
    with the Tent defaults of the parity tests, updated by ``tta``."""
    base = {"method": method, "steps": 1, "lr": 1e-3, "optimizer": "sgd", "momentum": 0.9,
            "update": "norm", "episodic": True}
    base.update(tta)
    crit = {"softmax": True, "sigmoid": False} if softmax else {"sigmoid": True}
    return {"task": {"seed": TTA_SEED}, "training": {"criterion": crit}, "tta": base}


def dryrun_params(seed: int = 0, num_classes: int = 1):
    """Randomized params of the dryrun UNet3D (16^3 volumes)."""
    from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D

    x0 = np.zeros((1, 16, 16, 16, 2), np.float32)
    return randomize(np_params(JaxUNet3D(**dict(DRYRUN, num_classes=num_classes)), x0, train=False), seed)


def volumes(n: int, seed: int = 0, shape=(2, 16, 16, 16, 2)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 100).astype(np.float32) for _ in range(n)]


def jax_trainable_paths(params) -> list:
    """'/'-joined paths of the JAX Tent adapter's norm-affine leaves, in the
    order its tree functions flatten them (the order of its restore keys)."""
    from multimodal_tta_tpu.tta.tent import norm_param_mask as jax_norm_param_mask

    mask = jax_norm_param_mask(params)
    trainable = jax.tree_util.tree_map(lambda p, m: p if m else None, params, mask)
    return ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(trainable)[0]]


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jax_dropout(key, b: int, m: int, prob: float) -> torch.Tensor:
    k1, k2 = jax.random.split(key)
    drop = jax.random.uniform(k1, (b, m)) < prob
    keep = jax.random.randint(k2, (b,), 0, m)
    return _t(jnp.where(jax.nn.one_hot(keep, m, dtype=bool), False, drop))


def _jax_scale_shift(key, nb: int, scale: float, shift: float):
    """``rand_intensity_scale_shift`` with prob 1: (factor, offset)."""
    _, k2, _, k4 = jax.random.split(key, 4)
    factor = 1.0 + jax.random.uniform(k2, (nb,), minval=-scale, maxval=scale)
    offset = jax.random.uniform(k4, (nb,), minval=-shift, maxval=shift)
    return _t(factor.astype(jnp.float32)), _t(offset.astype(jnp.float32))


def _jax_restore(key, adapter, paths, prob):
    """The reference's restore masks, in the port adapter's param order."""
    shapes = {flax_path(n): tuple(p.shape) for n, p in zip(adapter._names, adapter._trainable)}
    masks = {path: _t(jax.random.bernoulli(k, prob, shapes[path]))
             for k, path in zip(jax.random.split(key, len(paths)), paths)}
    return [masks[flax_path(n)] for n in adapter._names]


def _jax_views(key, n: int, shape, scale: float, shift: float, noise: float):
    out = []
    for k in (jax.random.split(key, n) if n > 0 else []):
        k_int, k_noise = jax.random.split(k)
        factor, offset = _jax_scale_shift(k_int, shape[0], scale, shift)
        z = _t(jax.random.normal(k_noise, tuple(shape), jnp.float32)) if noise > 0.0 else None
        out.append((factor, offset, z))
    return out


class JaxDraws:
    """Stands in for a port adapter's ``batch_draws``: the draws the JAX
    adapter of the same config takes from its ``PRNGKey(task.seed + 777)``,
    rebuilt from the reference's key-split order (tent.py grad_step: the
    restore key first, then ``k_md, k_obj``; sar.py: the step key is the
    dropout key; cotta.py: the restore key, then ``k_views, k_md``; memo.py:
    the restore key, then ``k_md, k_views``; a post-update ensemble from
    ``fold_in(batch key, steps)``)."""

    def __init__(self, adapter, params):
        self.ad = adapter
        self.paths = jax_trainable_paths(params)
        self.rng = jax.random.PRNGKey(TTA_SEED + 777)

    def __call__(self, shape, n_valid, post=False):
        self.rng, key = jax.random.split(self.rng)
        steps = [self.step(k, shape, n_valid) for k in jax.random.split(key, self.ad.steps)]
        post_d = None
        if post:
            post_d = self.views(jax.random.fold_in(key, self.ad.steps), shape)
        return {"steps": steps, "post": post_d}

    def views(self, key, shape):
        ad = self.ad
        return _jax_views(key, ad.n_views - 1, shape, ad.aug_scale, ad.aug_shift, ad.aug_noise)

    def step(self, key, shape, n_valid):
        ad, b, m = self.ad, shape[0], shape[-1]
        method = ad.method
        d = {"restore": None, "drop": None, "windows": None, "cons": None}
        if method == "sar":
            if ad.md_enabled:
                d["drop"] = _jax_dropout(key, b, m, ad.md_prob)
            return d
        if method == "cotta":
            key, k_rst = jax.random.split(key)
            k_views, k_md = jax.random.split(key)
        else:
            if ad.restore_enabled:
                key, k_rst = jax.random.split(key)
            if method == "memo":
                k_md, k_views = jax.random.split(key)
            else:
                k_md, k_obj = jax.random.split(key)
        if ad.restore_enabled:
            d["restore"] = _jax_restore(k_rst, ad, self.paths, ad.restore_prob)
        if ad.md_enabled:
            d["drop"] = _jax_dropout(k_md, b, m, ad.md_prob)
        if method in ("cotta", "memo"):
            d["views"] = self.views(k_views, shape)
            return d
        k_cons, nb = k_obj, b
        if ad.window_enabled:
            k_crop, k_cons = jax.random.split(k_obj)
            ks, kd, kh, kw = jax.random.split(k_crop, 4)
            w = ad.windows_per_step
            cols = [jax.random.randint(ks, (w,), 0, max(n_valid, 1))]
            for kk, size, r in zip((kd, kh, kw), shape[1:4], ad.window_roi):
                cols.append(jax.random.randint(kk, (w,), 0, max(size - r, 0) + 1))
            d["windows"] = _t(jnp.stack(cols, axis=1), torch.int64)
            nb = w
        if ad.loss_mode.endswith("+consistency"):
            d["cons"] = _jax_scale_shift(k_cons, nb, ad.cons_scale, ad.cons_shift)
        return d


def jax_state(params, num_classes: int = 1, module=None, batch_stats=None, apply_fn=None):
    """A JAX ``TrainState`` of ``module`` (default: the dryrun UNet3D), with
    ``batch_stats`` for a BatchNorm model; ``apply_fn`` replaces
    ``module.apply`` (``classifier_logits_apply``)."""
    import optax

    from multimodal_tta_tpu.core.train_state import TrainState
    from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D

    jm = module if module is not None else JaxUNet3D(**dict(DRYRUN, num_classes=num_classes))
    bs = None if batch_stats is None else jax.tree_util.tree_map(jnp.asarray, batch_stats)
    return TrainState.create(apply_fn=apply_fn or jm.apply, params=jax.tree_util.tree_map(jnp.asarray, params),
                             tx=optax.identity(), batch_stats=bs)


def bn_unet_variables(seed: int = 0, num_classes: int = 1, cfg=None, shape=None):
    """``random_flax_params`` and running statistics (mean near 0, var in
    [0.5, 2]) of a UNet3D with norm BATCH (default: the SMALL one on
    ``SMALL_SHAPE``), as nested numpy. Training-mode BatchNorm over few
    values per channel is ill-conditioned in f32 (a dryrun UNet3D's 1x1x1
    bottleneck at batch 2 takes its variance from 2 values, and both
    packages then sit up to 2e-4 off an f64 run), so the parity tests keep
    at least 64 values per channel."""
    from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D

    cfg = dict(SMALL if cfg is None else cfg, num_classes=num_classes)
    x_shape = (1,) + tuple(SMALL_SHAPE if shape is None else shape)
    jm = JaxUNet3D(**cfg, norm="BATCH")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))
    rng = np.random.RandomState(seed + 50)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.3 * rng.randn(*a.shape) if str(getattr(path[-1], "key", "")) == "mean"
                         else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32), shapes["batch_stats"])
    return {"params": random_flax_params(jm, x_shape, seed), "batch_stats": stats}


def run_jax_adapter(cls, params, cfg_dict, batches, n_valid, mode, threshold=0.3, floors=None,
                    num_classes=1, module=None, device_transform=DEVICE_TRANSFORM):
    """A JAX adapter over ``batches``: ``mode`` None = ``make_adapt_fn``,
    else ``make_adapt_predict_fn`` in that mode. ``module`` is the flax
    model (default: the dryrun UNet3D). Returns the adapted params as a port
    state dict, the entropy trace per batch, the predictions and the
    adapter."""
    from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode

    cfg = JaxConfigNode(cfg_dict)
    state = jax_state(params, num_classes, module)
    adapter = cls(cfg.tta, config=cfg, mesh=None, device_transform=device_transform)
    if mode is None:
        fn = adapter.make_adapt_fn(state)
    else:
        fn = adapter.make_adapt_predict_fn(state, threshold=threshold, predict_mode=mode)
    cur, ents, preds = state, [], []
    for i, x in enumerate(batches):
        floor = None if floors is None else floors[i]
        out = fn(cur, jnp.asarray(x), n_valid, ent_floor=floor)
        if mode is None:
            cur = out
        else:
            cur, pred = out
            preds.append(np.asarray(pred))
        ents.append(np.asarray(adapter._last_ents))
    adapted = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    return adapted, ents, preds, adapter


def run_torch_adapter(cls, params, cfg_dict, batches, n_valid, mode, threshold=0.3, floors=None,
                      num_classes=1, model=None, device_transform=DEVICE_TRANSFORM):
    """The port's adapter the same way, its draws from ``JaxDraws``;
    ``model`` is the port model holding ``params`` (default: the dryrun
    UNet3D)."""
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    cfg = ConfigNode(cfg_dict)
    if model is None:
        model = load_flax(UNet3D(**dict(DRYRUN, num_classes=num_classes), device="cpu"), params)
    adapter = cls(cfg.tta, config=cfg, device_transform=device_transform, device="cpu")
    adapter.batch_draws = JaxDraws(adapter, params)
    if mode is None:
        fn = adapter.make_adapt_fn(model)
    else:
        fn = adapter.make_adapt_predict_fn(model, threshold=threshold, predict_mode=mode)
    ents, preds = [], []
    for i, x in enumerate(batches):
        floor = None if floors is None else floors[i]
        out = fn(model, torch.from_numpy(x), n_valid, ent_floor=floor)
        if mode is not None:
            assert out[0] is model and out[1].dtype == torch.uint8
            preds.append(out[1].numpy())
        ents.append(adapter._last_ents.numpy())
    adapted = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return adapted, ents, preds, adapter


def assert_adapted_close(t_adapted, j_adapted, source, names, rel=1e-3):
    """Adapted-minus-source deltas of ``names`` within ``rel`` relative L2;
    every other tensor at its source value."""
    dj = torch.cat([(j_adapted[n] - source[n]).flatten() for n in names])
    dt = torch.cat([(t_adapted[n] - source[n]).flatten() for n in names])
    assert float(dj.norm()) > 0
    assert float((dt - dj).norm() / dj.norm()) < rel, float((dt - dj).norm() / dj.norm())
    for n in t_adapted:
        if n not in names:
            assert torch.equal(t_adapted[n], source[n]), n


def assert_stats_close(got: dict, want: dict, rel: float = 1e-5) -> int:
    """Every running statistic (``.mean`` / ``.var`` buffer) of ``want``
    within ``rel`` of the tensor's largest magnitude in ``got``; returns how
    many were compared. (flax takes the variance as E[x^2] - E[x]^2, so its
    error scales with E[x^2], not with the variance: an elementwise bound on
    a near-zero entry would hold the two packages to their summation
    order.)"""
    keys = [k for k in want if k.rpartition(".")[2] in ("mean", "var")]
    for k in keys:
        w, g = want[k].double(), got[k].double()
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-12, (k, err, float(w.abs().max()))
    return len(keys)


def assert_preds_close(t_preds, j_preds, agree=0.999):
    assert len(t_preds) == len(j_preds)
    for a, b in zip(t_preds, j_preds):
        assert a.shape == b.shape
        assert (a == b).mean() >= agree


class NormCalls:
    """Counts InstanceNorm forwards and backwards (on the card, each is one
    kernel launch) through global module hooks, for the whole process. A
    forward counts when it starts: under remat, the recomputation stops
    (torch.utils.checkpoint's early stop) inside the last norm of a segment
    once that norm has saved its tensors, after its kernel ran, so the
    module never returns there."""

    def __init__(self):
        from multimodal_tta_tpu_torch.models.layers import InstanceNorm

        self.fwd = self.bwd = 0

        def pre_hook(module, args):
            if isinstance(module, InstanceNorm):
                self.fwd += 1

        def hook(module, args, output):
            if isinstance(module, InstanceNorm) and output.requires_grad:
                output.register_hook(self._backward)

        self.handles = [torch.nn.modules.module.register_module_forward_pre_hook(pre_hook),
                        torch.nn.modules.module.register_module_forward_hook(hook)]

    def _backward(self, grad):
        self.bwd += 1

    def reset(self):
        self.fwd = self.bwd = 0

    def read(self):
        return {"forward": self.fwd, "backward": self.bwd}

    def remove(self):
        for h in self.handles:
            h.remove()


# ---------------------------------------------------------------------------
# SegTrainer parity on any model (tests/test_torch_moe.py,
# test_torch_deep_supervision.py, test_torch_distill.py): the JAX trainer
# over a flax module and the port's over a port model holding the same params

HECKTOR_CRITERION = {"sigmoid": True, "lambda_dice": 5.0, "lambda_ce": 1.0, "ce_weight": [50.0],
                     "include_background": False}
NO_DECAY = {"no_decay_keys": ["bias", "bn", "norm", "scale"], "treat_1d_as_no_decay": True}
ADAM = {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4, "betas": [0.9, 0.9999]}}}
# a transformer's attention key bias has a zero gradient up to rounding,
# which Adam would scale up to a full step: its steps take SGD
SGD = {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}}


def trainer_config(training: dict, model: dict = None, **top) -> dict:
    t = {"param_groups": NO_DECAY, "criterion": HECKTOR_CRITERION, "compute_dtype": "float32"}
    t.update(training)
    return {"task": {"seed": 0}, "training": t, "model": dict(model or {}), **top}


def trainer_pair(cfg: dict, jax_module, port_model: torch.nn.Module, params, device_transform=DEVICE_TRANSFORM):
    """``(jax SegTrainer, port SegTrainer)`` over ``jax_module`` and
    ``port_model`` (loaded here with ``params``), each with its package's
    optimizer and scheduler from ``cfg``."""
    from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
    from multimodal_tta_tpu.core import optim as joptim
    from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
    from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core import optim as toptim
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer

    jcfg = JaxConfigNode(cfg)
    jt = JaxSegTrainer(jcfg, mesh=None, device_transform=device_transform)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    jt.setup(JaxTrainState.create(apply_fn=jax_module.apply, params=jparams, tx=tx), None,
             joptim.EpochScheduler(jcfg.training, lr))
    pcfg = ConfigNode(cfg)
    pt = SegTrainer(pcfg, device_transform=device_transform, device="cpu")
    port_model.load_state_dict(unet3d_from_flax(params), strict=True)
    optimizer, lr = toptim.build_optimizer(pcfg.training, port_model)
    pt.setup(TrainState(model=port_model, optimizer=optimizer), None, toptim.EpochScheduler(pcfg.training, lr))
    return jt, pt


def assert_steps_match(jt, pt, batches, what: str, loss_rtol: float = 2e-5, param_rtol: float = 1e-5,
                       param_atol: float = 2e-6) -> list:
    """``run_step`` both trainers over ``batches``: each step's loss within
    ``loss_rtol`` and the params after it within ``param_rtol`` relative
    plus ``param_atol`` absolute (``tests/test_torch_seg_trainer.py``'s
    tolerances; Adam's atol grows with the step, as there). Returns the
    port's losses."""
    inner = getattr(pt.state.optimizer, "optimizer", pt.state.optimizer)  # through MultiSteps
    adam = type(inner).__name__ in ("Adam", "AdamW")
    losses = []
    for i, batch in enumerate(batches):
        jt.run_step(batch)
        pt.run_step(batch)
        want, got = jt.flush_step_metrics()["loss"], pt.flush_step_metrics()["loss"]
        np.testing.assert_allclose(got, want, rtol=loss_rtol, err_msg=f"{what}: loss of step {i}")
        ref = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
        params = dict(pt.state.model.named_parameters())
        assert set(params) == set(ref)
        atol = param_atol * (i + 2 if adam else 1)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=param_rtol, atol=atol,
                                       err_msg=f"{what}: {n} after step {i}")
        losses.append(got)
    return losses
