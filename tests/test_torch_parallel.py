"""The port's ``parallel/`` against the JAX package's ``parallel/mesh.py`` and
``parallel/distributed.py``, in one process: ``pad_batch_to_multiple``
(arrays and count equal), device selection from ``training.devices`` and
``training.gpu_ids`` (the same indices as the reference's, one rank per
local rank), the mesh's size errors (the reference's messages), the axes
that are not ported, a rank's rows and the layouts, and what a run without a
process group sees. The ranks themselves are in
``tests/test_torch_data_parallel.py``."""

import jax
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.parallel import mesh as jmesh
from multimodal_tta_tpu_torch import parallel
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.parallel import distributed, mesh


@pytest.mark.parametrize("n,multiple,keys", [(5, 2, ("image", "label")), (4, 2, ("image", "label")),
                                             (3, 4, ("image",)), (7, 3, ("image", "label")), (2, 1, ("label",))])
def test_pad_batch_to_multiple_matches_reference(n, multiple, keys):
    rng = np.random.RandomState(n)
    batch = {"image": rng.randn(n, 2, 3, 1).astype(np.float32), "label": (rng.rand(n, 2, 3, 1) > 0.5),
             "domain": ["a"] * n}
    got, gn = mesh.pad_batch_to_multiple(batch, multiple, array_keys=keys)
    want, wn = jmesh.pad_batch_to_multiple(batch, multiple, array_keys=keys)
    assert gn == wn == n and set(got) == set(want)
    for k in want:
        if k == "domain":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    assert mesh.pad_batch_to_multiple({"x": 1}, 2) == jmesh.pad_batch_to_multiple({"x": 1}, 2)


def _cuda_host(monkeypatch, cards: int, local_ranks: int):
    """A host with ``cards`` cards and ``local_ranks`` torchrun ranks, as
    ``select_devices`` reads it."""
    monkeypatch.setattr(mesh, "resolve_device",
                        lambda device="cuda": torch.device("cpu" if device == "cpu" else "cuda:0"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))


@pytest.mark.parametrize("training,ranks", [
    ({"devices": [1, 3]}, 2), ({"devices": [0, 0]}, 2), ({"devices": "auto"}, 4), ({"devices": "all"}, 2),
    ({"devices": "auto", "gpu_ids": [2, 3]}, 2), ({"devices": "auto", "gpu_ids": [0]}, 4),
    ({"devices": "tpu", "gpu_ids": [5, 1, 2]}, 2)])
def test_device_selection_matches_reference(monkeypatch, training, ranks):
    """Each local rank gets the card the reference lists at its index
    (``gpu_ids`` out of range are dropped, the ``[0]`` singleton ignored)."""
    _cuda_host(monkeypatch, len(jax.devices()), ranks)
    got = [d.index for d in mesh.select_devices(ConfigNode(training))]
    want = [d.id for d in jmesh.select_devices(JaxConfigNode(training))][:ranks]
    assert got == want and len(got) == ranks


def test_device_selection_errors(monkeypatch):
    _cuda_host(monkeypatch, 2, 4)
    with pytest.raises(ValueError, match="4 ranks on this host but 2 device"):
        mesh.select_devices(ConfigNode({"devices": [0, 1]}))
    with pytest.raises(ValueError, match="out of range"):  # more ranks than cards: never shared silently
        mesh.select_devices(ConfigNode({"devices": "auto"}))
    with pytest.raises(ValueError, match="Unrecognized training.devices: 'gpu'"):
        mesh.select_devices(ConfigNode({"devices": "gpu"}))
    with pytest.raises(ValueError, match="Unrecognized training.devices: 'gpu'"):
        jmesh.select_devices(JaxConfigNode({"devices": "gpu"}))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert mesh.select_devices(None, "cpu") == [torch.device("cpu")] * 3


@pytest.mark.parametrize("training,ranks,backend", [
    ({"devices": [0, 1]}, 2, "nccl"), ({"devices": [0, 0]}, 2, "gloo"), ({"devices": [0, 0]}, 1, "nccl"),
    ({"devices": "auto"}, 2, "nccl"), ({"devices": [1, 0, 1]}, 3, "gloo")])
def test_backend_from_the_selected_devices(monkeypatch, training, ranks, backend):
    """NCCL for ranks on distinct cards; gloo where two ranks of the host
    share a card (NCCL refuses them) and on the CPU; chosen from the
    devices before any group exists."""
    _cuda_host(monkeypatch, 2, ranks)
    devices = mesh.select_devices(ConfigNode(training))
    assert distributed.default_backend(devices) == backend
    assert distributed.default_backend("cpu") == distributed.default_backend([torch.device("cpu")] * 2) == "gloo"
    assert distributed.default_backend(torch.device("cuda", 0)) == "nccl"


@pytest.mark.parametrize("n,axes", [(8, {}), (8, {"data": 8}), (8, {"data": 4}), (8, {"data": 3}),
                                    (8, {"space": 3}), (6, {"data": -1, "model": 4}), (4, {"stage": 3}),
                                    (2, {"data": 3})])
def test_mesh_size_errors_match_reference(n, axes):
    """The data axis over ``n`` ranks: the reference's sizes and its
    ``ValueError`` messages, checked before the unported axes."""
    try:
        want = jmesh.make_mesh(jax.devices()[:n], **axes).shape["data"]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.axis_sizes(n, **axes)
        assert str(got.value) == str(e)
        return
    assert mesh.axis_sizes(n, **axes) == want


@pytest.mark.parametrize("axis,item", [("model", "12b-v"), ("expert", "12b-v"), ("stage", "12b-v")])
def test_unported_axes_raise(axis, item):
    """The model, expert and stage axes run over ranks
    (``tests/test_torch_tensor_parallel.py``, ``test_torch_expert_parallel.py``,
    ``test_torch_pipeline.py``), in the reference's axis order; beside a
    space axis too since item 12b-v's last part (``tests/test_torch_space_axes.py``):
    the space group pairs the ranks of one index on the other axis, the
    sums run over data x space, and such a mesh needs a process group."""
    assert mesh.axis_sizes(4, **{axis: 2}) == 2
    m = mesh.Mesh.__new__(mesh.Mesh)
    m.data, m.space, m.rank = 2, 1, 3
    setattr(m, axis, 2)
    assert m.shape == {"data": 2, "space": 1, axis: 2} and getattr(m, f"{axis}_rank") == 1 and m.data_rank == 1
    sizes = [1, 2] + [2 if a == axis else 1 for a in ("model", "expert", "stage")]
    assert mesh.axis_groups(sizes, "space") == mesh.axis_groups(sizes, "data", "space") == [[0, 2], [1, 3]]
    assert mesh.axis_groups(sizes, axis) == [[0, 1], [2, 3]] and item.startswith("12b-v")
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.Mesh(torch.device("cpu"), data=1, space=2, **{axis: 2})
    assert mesh.make_mesh([torch.device("cpu")], **{axis: 1}).data == 1  # a size of 1 is no axis


def test_space_axis_sizes_rows_and_slabs():
    """A ``data x space`` mesh: the reference's data size beside the space
    axis, and rank ``(d, s) = divmod(r, space)`` holding data rank d's rows
    and depth slab s of the global batch (``local``), its shape the real
    axes."""
    assert mesh.axis_sizes(4, space=2) == jmesh.make_mesh(jax.devices()[:4], space=2).shape["data"] == 2
    assert mesh.axis_sizes(2, data=1, space=2) == 1
    batch = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3, 1)
    for r in range(4):
        m = mesh.Mesh.__new__(mesh.Mesh)
        m.data, m.space, m.rank = 2, 2, r
        d, s = divmod(r, 2)
        assert (m.data_rank, m.space_rank, m.size, m.parallel) == (d, s, 4, True)
        assert m.shape == {"data": 2, "space": 2}
        assert m.rows(4) == slice(2 * d, 2 * d + 2) and m.slab(8) == slice(4 * s, 4 * s + 4)
        np.testing.assert_array_equal(m.local(batch), batch[2 * d:2 * d + 2, 4 * s:4 * s + 4])
    with pytest.raises(ValueError, match="does not split over a space axis of 2"):
        m.slab(7)


def test_one_process_mesh_rows_and_layouts():
    """Without a process group the mesh is one rank on the caller's device:
    the identity collectives, all rows, the layouts' placement."""
    assert not distributed.maybe_initialize_distributed(device="cpu")
    assert distributed.is_primary_host() and distributed.from_primary("x") == "x"
    distributed.barrier()
    m = mesh.mesh_from_config(ConfigNode({"training": {"devices": "auto"}}), "cpu")
    assert (m.data, m.rank, m.device, m.parallel) == (1, 0, torch.device("cpu"), False)
    assert m.shape == {"data": 1, "space": 1} and mesh.data_axis_size(m) == 1 == mesh.data_axis_size(None)
    t = torch.arange(6.0)
    assert m.sum(t) is t and m.sum_with_grad(t) is t and m.gather_rows(t) is t
    assert m.rows(6) == slice(0, 6)
    batch = {"image": np.ones((4, 2), np.float32), "label": torch.zeros(4, 1), "domain": ["a"] * 4,
             "n": np.float32(3)}
    out = mesh.shard_batch(batch, m)
    assert isinstance(out["image"], torch.Tensor) and out["image"].shape == (4, 2)
    assert out["domain"] == batch["domain"] and out["n"] == batch["n"]
    assert mesh.replicated(m).place(np.ones(3)).shape == (3,)
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.Mesh(torch.device("cpu"), data=2, rank=1)


def test_rows_of_each_rank():
    """Rank r of w holds rows [r*B/w, (r+1)*B/w) of the padded global batch."""
    m = mesh.Mesh.__new__(mesh.Mesh)
    m.data, m.rank = 4, 3
    assert m.rows(8) == slice(6, 8)
    with pytest.raises(ValueError, match="does not split"):
        m.rows(6)


def test_exports_match_reference_but_the_pipeline():
    """Every name of the reference's ``parallel.__all__`` is exported, the
    pipeline's five included since its port."""
    import multimodal_tta_tpu.parallel as jparallel

    pipeline = {"pipeline_apply", "pipeline_value_and_grad", "make_pipeline_train_step", "stack_layer_params",
                "vit_forward_pipelined"}
    assert not set(jparallel.__all__) - set(parallel.__all__) and pipeline <= set(parallel.__all__)
