"""Pretrained weights from torchvision-named state_dicts (the port of
``multimodal_tta_tpu/models/pretrained.py``).

``model.pretrained: true`` with ``model.pretrained_source`` pointing at a
``torch.save(model.state_dict(), path)`` file of a torchvision backbone
initializes the registry model from it; nothing is downloaded. No source, or
a family without a porter, is a hard error: a model the user believes
pretrained but that is random is the worst failure mode.

The port's models carry flax's module names, not torchvision's, so a state
dict cannot be loaded as it is. ``torchvision_names`` is the one name map:
each of the model's tensors to its torchvision name (the reference's name
contracts, one function a family below). ``load_pretrained`` reads a file
through it and ``to_torchvision`` writes one. The layouts need no transpose
(the port holds torch's OIHW convs and ``[out, in]`` linears); a norm's
``weight`` is the port's ``scale``, a BatchNorm's ``running_mean`` /
``running_var`` its buffers ``mean`` / ``var``, and ``num_batches_tracked``
is dropped. ViT's fused ``in_proj`` holds the ``query``/``key``/``value``
linears in its three thirds.

``load_pretrained`` checks the file tensor by tensor against the model: a
name the model has no home for or a wrong shape raises, and the model's
tensors the file does not provide (a head left out of it) stay at their
random init and are logged.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.logger import get_logger

StateDict = Dict[str, torch.Tensor]

# a tensor's leaf name -> torchvision's (the others keep theirs)
_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_QKV = ("query", "key", "value")
# torchvision renamed ViT's MLP linears between versions (mlp.0 / mlp.3)
_ALIASES = ((".mlp.linear_1.", ".mlp.0."), (".mlp.linear_2.", ".mlp.3."))


def load_torch_state_dict(path: str) -> StateDict:
    """A bare state_dict, or the one a checkpoint dict carries under
    ``state_dict`` / ``model`` / ``model_state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"[pretrained] {path} does not contain a state_dict")
    return obj


_RESNET = {"stem": "conv1", "stem_bn": "bn1", "fc": "fc"}


def _resnet(mod: str, variant: str) -> Optional[str]:
    """Port ``stem``/``stem_bn``, ``layer{L}_{J}.Conv_{K}``/``BatchNorm_{K}``,
    ``downsample_conv``/``downsample_bn``, ``fc``; torchvision ``conv1``/
    ``bn1``, ``layer{L}.{J}.conv{K+1}``/``bn{K+1}``, ``downsample.0/1``,
    ``fc``. The re-ID projection and BNNeck have no counterpart."""
    if mod in _RESNET:
        return _RESNET[mod]
    m = re.fullmatch(r"layer(\d+)_(\d+)\.(Conv|BatchNorm)_(\d+)", mod)
    if m:
        return f"layer{m[1]}.{m[2]}.{'conv' if m[3] == 'Conv' else 'bn'}{int(m[4]) + 1}"
    m = re.fullmatch(r"layer(\d+)_(\d+)\.downsample_(conv|bn)", mod)
    if m:
        return f"layer{m[1]}.{m[2]}.downsample.{0 if m[3] == 'conv' else 1}"
    return None


_DENSENET = {"Conv_0": "features.conv0", "BatchNorm_0": "features.norm0", "final_bn": "features.norm5",
             "classifier": "classifier"}
_DENSE_LAYER = {"BatchNorm_0": "norm1", "Conv_0": "conv1", "BatchNorm_1": "norm2", "Conv_1": "conv2"}


def _densenet(mod: str, variant: str) -> Optional[str]:
    """Port ``Conv_0``/``BatchNorm_0`` stem, ``block{B}_layer{L}.{BatchNorm_0,
    Conv_0,BatchNorm_1,Conv_1}``, ``transition{T}.{BatchNorm_0,Conv_0}``,
    ``final_bn``, ``classifier``; torchvision ``features.conv0``/``norm0``,
    ``features.denseblock{B+1}.denselayer{L+1}.{norm1,conv1,norm2,conv2}``,
    ``features.transition{T+1}.{norm,conv}``, ``features.norm5``,
    ``classifier``."""
    if mod in _DENSENET:
        return _DENSENET[mod]
    m = re.fullmatch(r"block(\d+)_layer(\d+)\.(\w+)", mod)
    if m and m[3] in _DENSE_LAYER:
        return f"features.denseblock{int(m[1]) + 1}.denselayer{int(m[2]) + 1}.{_DENSE_LAYER[m[3]]}"
    m = re.fullmatch(r"transition(\d+)\.(BatchNorm|Conv)_0", mod)
    if m:
        return f"features.transition{int(m[1]) + 1}.{'norm' if m[2] == 'BatchNorm' else 'conv'}"
    return None


def _efficientnet(mod: str, variant: str) -> Optional[str]:
    """Port ``stem``/``stem_bn``, ``stage{S}_block{J}.{Conv_i,BatchNorm_i,
    SqueezeExcite_0.Conv_{0,1}}``, ``head_conv``/``head_bn``, ``classifier``;
    torchvision ``features.0.{0,1}``, ``features.{S+1}.{J}.block.{t}.{0,1}``
    and ``block.{t}.fc{1,2}`` for the SE, ``features.{last}.{0,1}``,
    ``classifier.1``. The SE takes torchvision's block index 1 (MBConv with
    expand 1) or 2 (MBConv), so the project conv after it moves up one; a
    FusedMBConv has no SE. The stage layout is the port's own spec."""
    from .efficientnet import stages_of

    stages = stages_of(variant)
    last = f"features.{len(stages) + 1}"
    fixed = {"stem": "features.0.0", "stem_bn": "features.0.1", "head_conv": f"{last}.0", "head_bn": f"{last}.1",
             "classifier": "classifier.1"}
    if mod in fixed:
        return fixed[mod]
    m = re.fullmatch(r"stage(\d+)_block(\d+)\.(.+)", mod)
    if not m:
        return None
    expand, fused = stages[int(m[1])][0], stages[int(m[1])][5]
    se_at = 1 if expand == 1 else 2
    block = f"features.{int(m[1]) + 1}.{m[2]}.block"
    se = re.fullmatch(r"SqueezeExcite_0\.Conv_([01])", m[3])
    if se:
        return f"{block}.{se_at}.fc{int(se[1]) + 1}"
    k = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", m[3])
    if not k:
        return None
    i = int(k[2])
    return f"{block}.{i + 1 if not fused and i == se_at else i}.{0 if k[1] == 'Conv' else 1}"


_VIT = {"patch_embed": "conv_proj", "final_ln": "encoder.ln", "head": "heads.head"}
_VIT_BLOCK = {"LayerNorm_0": "ln_1", "LayerNorm_1": "ln_2", "Dense_0": "mlp.0", "Dense_1": "mlp.3",
              "MultiHeadDotProductAttention_0.out": "self_attention.out_proj"}


def _vit(mod: str, variant: str) -> Optional[str]:
    """Port ``patch_embed``, ``block{i}.{LayerNorm_0, MultiHeadDotProductAttention_0.out,
    LayerNorm_1, Dense_0, Dense_1}``, ``final_ln``, ``head``; torchvision
    ``conv_proj``, ``encoder.layers.encoder_layer_{i}.{ln_1,
    self_attention.out_proj, ln_2, mlp.0, mlp.3}``, ``encoder.ln``,
    ``heads.head``. ``cls_token``/``pos_embed`` and the q/k/v thirds of
    ``in_proj`` are in ``torchvision_names``."""
    if mod in _VIT:
        return _VIT[mod]
    m = re.fullmatch(r"block(\d+)\.(.+)", mod)
    if m and m[2] in _VIT_BLOCK:
        return f"encoder.layers.encoder_layer_{m[1]}.{_VIT_BLOCK[m[2]]}"
    return None


_FAMILIES = {"resnet": _resnet, "densenet": _densenet, "efficientnet": _efficientnet, "vit": _vit}
_VIT_TOP = {"cls_token": "class_token", "pos_embed": "encoder.pos_embedding"}
_QKV_RE = re.compile(r"block(\d+)\.MultiHeadDotProductAttention_0\.(query|key|value)\.(weight|bias)")


def _family_of(model_name: str) -> str:
    name = str(model_name).lower()
    for fam in ("resnet", "densenet", "efficientnet", "vit"):
        if name.startswith(fam) or name.startswith(f"{fam[0]}_") or fam in name:
            return fam
    return name


def torchvision_names(model: nn.Module, model_name: str) -> Dict[str, Tuple[str, Optional[int]]]:
    """Each of ``model``'s tensors that torchvision has -> ``(its torchvision
    name, the third of a fused ``in_proj`` it is, else None)``."""
    fam = _family_of(model_name)
    tv_module = _FAMILIES.get(fam)
    if tv_module is None:
        raise NotImplementedError(
            f"[pretrained] no torchvision porter exists for model family '{fam}' (model "
            f"'{model_name}'); porters: {sorted(_FAMILIES)}. Refusing to continue with random "
            f"weights while the config requests pretrained ones.")
    out = {}
    for name in model.state_dict():
        qkv = _QKV_RE.fullmatch(name) if fam == "vit" else None
        if qkv:
            out[name] = (f"encoder.layers.encoder_layer_{qkv[1]}.self_attention.in_proj_{qkv[3]}",
                         _QKV.index(qkv[2]))
            continue
        if fam == "vit" and name in _VIT_TOP:
            out[name] = (_VIT_TOP[name], None)
            continue
        mod, _, leaf = name.rpartition(".")
        tv = tv_module(mod, model_name)
        if tv is not None:
            out[name] = (f"{tv}.{_LEAF.get(leaf, leaf)}", None)
    return out


@torch.no_grad()
def load_pretrained(model: nn.Module, model_name: str, source_path: str) -> nn.Module:
    """Copy the torchvision state dict at ``source_path`` into ``model`` (in
    place, on its device and in its dtypes). Every tensor of the file must
    have a home in the model and match its shape; the model's tensors the
    file does not provide stay at their random init and are logged."""
    logger = get_logger()
    names = torchvision_names(model, model_name)
    sd = {}
    for k, t in load_torch_state_dict(source_path).items():
        for old, new in _ALIASES:
            k = k.replace(old, new)
        if not k.endswith(".num_batches_tracked"):
            sd[k] = t
    homes = {tv for tv, _ in names.values()}
    unknown = [k for k in sd if k not in homes]
    if unknown:
        raise ValueError(f"[pretrained] {len(unknown)} tensors of {source_path} have no home in the model "
                         f"'{model_name}': {unknown[:8]}{'...' if len(unknown) > 8 else ''}")
    own = model.state_dict()
    loaded = {}
    for name, (tv, third) in names.items():
        if tv not in sd:
            continue
        t = sd[tv] if third is None else sd[tv].chunk(3)[third]
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"[pretrained] shape mismatch at {tv}: checkpoint {tuple(t.shape)} vs model "
                             f"{name} {tuple(own[name].shape)} (model '{model_name}')")
        loaded[name] = t
    for name, t in loaded.items():
        own[name].copy_(t)
    missed = [k for k in own if k not in loaded]
    if missed:
        logger.info(f"[pretrained] {len(missed)} leaves stay at random init (not in checkpoint): "
                    f"{missed[:6]}{'...' if len(missed) > 6 else ''}")
    logger.info(f"[pretrained] loaded {len(loaded)}/{len(own)} tensors into '{model_name}'")
    return model


@torch.no_grad()
def to_torchvision(model: nn.Module, model_name: str) -> StateDict:
    """``model``'s tensors under torchvision's names, on the CPU, as
    ``torch.save(tv_model.state_dict(), p)`` would write them (BatchNorms
    with ``num_batches_tracked``, q/k/v fused into ``in_proj``):
    ``torchvision_names`` the other way round."""
    own = model.state_dict()
    out: StateDict = {}
    thirds: Dict[str, list] = {}
    for name, (tv, third) in torchvision_names(model, model_name).items():
        t = own[name].detach().cpu().clone()
        if third is None:
            out[tv] = t
        else:
            thirds.setdefault(tv, [None] * 3)[third] = t
        if tv.endswith(".running_var"):
            out[tv[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    out.update({tv: torch.cat(parts) for tv, parts in thirds.items()})
    return out
