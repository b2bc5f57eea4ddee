"""The port's jax-free copies of the host data modules
(multimodal_tta_tpu_torch/data/loader.py, transforms.py, base_builder.py) and
its dataset-builder registry, against the JAX package's modules: the same
batches in the same order, the same transforms and device specs, the same
loader arguments. Exact: both sides are numpy on the host."""

import numpy as np
import pytest

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.data import base_builder as jbuilder
from multimodal_tta_tpu.data import loader as jloader
from multimodal_tta_tpu.data import transforms as jtransforms
from multimodal_tta_tpu_torch import registry
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.data import base_builder, loader, transforms

from _torch_port import HECKTOR_POLICY


def samples(n: int):
    rng = np.random.RandomState(0)
    return [{"image": rng.randn(2, 3, 4, 2).astype(np.float32), "label": rng.rand(2, 3, 4, 1) > 0.5,
             "idx": i, "weight": float(i) / 2, "domain": f"d{i % 3}"} for i in range(n)]


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, True, 0), (True, False, 2), (False, False, 3),
                                                       (False, True, 1)])
def test_host_loader_yields_the_reference_batches(shuffle, drop_last, workers):
    data = samples(11)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=workers, seed=3)
    ours, ref = loader.HostLoader(data, **kw), jloader.HostLoader(data, **kw)
    assert len(ours) == len(ref)
    for epoch in (None, 5, None):  # a named epoch, then the one after it
        if epoch is not None:
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["domain"] == w["domain"]
            for k in ("image", "label", "idx", "weight"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_seg_transform_matches_reference(on_device, split):
    kw = dict(ndim=3, split=split, normalize=True, geom_aug=True, intensity_aug=True,
              intensity_policy=HECKTOR_POLICY, channel_names=["ct", "pt"], image_size=[4, 6, 6],
              on_device=on_device, modality_dropout={"enabled": on_device, "prob": 0.3})
    ours, ref = transforms.get_seg_transforms(**kw), jtransforms.get_seg_transforms(**kw)
    assert ours.device_spec() == ref.device_spec()
    rng = np.random.RandomState(1)
    image = np.stack([rng.randn(4, 6, 6) * 400 - 300, np.abs(rng.randn(4, 6, 6)) * 4], -1).astype(np.float32)
    label = (rng.rand(4, 6, 6) > 0.7).astype(np.int64)
    for seed in range(6):  # rotations and intensity draws both ways
        got = ours(image, label, np.random.default_rng(seed))
        want = ref(image, label, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError, match="spatial mismatch"):
        ours(image[:3], label[:3])
    assert np.array_equal(transforms.normalize_host(image, mean=[1.0, 2.0], std=[2.0, 4.0]),
                          jtransforms.normalize_host(image, mean=[1.0, 2.0], std=[2.0, 4.0]))


def test_dataset_builder_base_and_registry():
    cfg = {"task": {"seed": 7}, "training": {"batch_size": 3, "eval_batch_size": 5, "num_workers": 1}}

    class Ours(base_builder.BaseDatasetBuilder):
        def build_dataset(self, split, **overrides):
            return samples(7)

    class Ref(jbuilder.BaseDatasetBuilder):
        def build_dataset(self, split, **overrides):
            return samples(7)

    ours, ref = Ours(ConfigNode(cfg)), Ref(JaxConfigNode(cfg))
    for split in ("train", "validation", "test"):
        assert ours.default_loader_args(split) == ref.default_loader_args(split)
        assert len(ours.get_loader(split)) == len(ref.get_loader(split))
    assert ours.get_loader("train") is ours.get_loader("train")  # cached
    assert ours.get_loader("val", batch_size=2).batch_size == 2
    with pytest.raises(ValueError, match="Unsupported split"):
        ours.get_loader("holdout")

    with pytest.raises(KeyError, match="not registered in dataset_builders"):
        registry.get_dataset_builder("no_such_task")
    registry.register_dataset_builder("port_test_builder")(Ours)
    try:
        assert registry.get_dataset_builder("port_test_builder") is Ours
    finally:
        registry.DATASET_BUILDERS._registry.pop("port_test_builder")
