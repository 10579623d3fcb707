"""The port's communication layer and its data-, tensor- and
pipeline-parallel paths against the JAX package and against the port's own
single-process computation: ``core/distributed.py``, ``core/mesh.py``,
``tasks/trainer.py`` on a mesh, ``parallel/tensor.py``,
``parallel/pipeline.py`` and ``core/checkpoint.py``'s sharded path.

Two 2-rank gloo worlds on the CPU (``tests/torch_port_ranks.py``), one per
layout, each spawned once for the module: data 2 (with a data 1 x space 2
mesh of the same ranks for the checkpoint) and model 2 (which also runs the
2-stage pipeline over its model axis).  JAX's references come from
``tests/data/torch_port_parallel_golden.npz``.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import make_torch_port_parallel_golden as gen  # noqa: E402
import torch_port_ranks  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    with np.load(gen.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    return torch_port_ranks.run_world("data2", str(tmp_path_factory.mktemp("data2")))


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    return torch_port_ranks.run_world("model2", str(tmp_path_factory.mktemp("model2")))


def test_make_mesh_lays_out_ranks_as_jax(data2, model2):
    """``make_mesh(data=-1)`` takes every rank; each rank's coordinate and
    its lines follow JAX's reshape order; host_shard and is_primary."""
    for rank, r in enumerate(data2):
        assert r["mesh/shape"] == {"data": 2, "model": 1, "space": 1}
        assert r["mesh/coords"] == {"data": rank, "model": 0, "space": 0}
        assert r["mesh/data_ranks"] == (0, 1) and r["mesh/space_ranks"] == (rank,)
        assert r["host_shard"] == (rank, 2) and r["primary"] == (rank == 0)
    assert all(r["mesh/model_ranks"] == (0, 1) for r in model2)


def test_param_sharding_rule():
    """The tensor-parallel rule, as JAX's: the output channel of a kernel
    of >= 2 dims when the model axis divides it and it reaches the
    threshold (256 by default); vectors and small kernels replicated."""
    from tpuseg_torch.core.distributed import AxisGroup
    from tpuseg_torch.core.mesh import Mesh, param_sharding_rule_fn, param_sharding_rules
    from tpuseg_torch.models.unet import UNet

    layout = np.arange(2).reshape(1, 2, 1)
    solo = AxisGroup((0,), 0)
    mesh = Mesh(layout, 0, "cpu", {axes: solo for axes in
                                   (("data",), ("model",), ("space",), ("data", "space"),
                                    ("data", "model", "space"))})
    rule = param_sharding_rule_fn(mesh)
    assert rule((256, 16, 3, 3, 3), 0) == 0 and rule((254, 16, 3, 3, 3), 0) is None
    assert rule((128, 16, 3, 3, 3), 0) is None and rule((512,), 0) is None
    spec = param_sharding_rules(mesh, UNet(2, features=16))
    assert {k for k, d in spec.items() if d is not None} == {
        "bottleneck.bottleneckconv1.weight", "bottleneck.bottleneckconv2.weight"}
    spec = param_sharding_rules(mesh, UNet(2, features=32))
    assert spec["upconv4.weight"] == 1 and spec["bottleneck.bottleneckconv1.weight"] == 0


def test_loader_host_shard():
    """``DataLoader(host_shard=(i, n))`` iterates every n-th sample of each
    epoch's order from i; the shards are disjoint and cover the epoch."""
    from tpuseg_torch.data.dataset import ArrayDataset, DataLoader

    ds = ArrayDataset([{"x": np.full((1,), i)} for i in range(10)])
    seen = []
    for i in range(2):
        loader = DataLoader(ds, 1, shuffle=True, seed=3, host_shard=(i, 2))
        assert len(loader) == 5
        seen.append([int(b["x"][0, 0]) for b in loader])
    full = [int(b["x"][0, 0]) for b in DataLoader(ds, 1, shuffle=True, seed=3)]
    assert seen[0] == full[0::2] and seen[1] == full[1::2]


def test_data_parallel_pooled_loss_step(data2, golden):
    """A data-2 step with MutilDiceLoss (class statistics summed over the
    data ranks): loss, metric and SGD update equal JAX's data-parallel
    trainer's and one process's step on the whole batch."""
    loss, ref_loss, metric, ref_metric, err = data2[0]["dp/MutilDiceLoss"]
    assert abs(loss - golden["trainer/d2s1/loss"]) <= F32_TOL
    assert abs(metric - golden["trainer/d2s1/metric"]) <= F32_TOL
    assert abs(loss - ref_loss) <= F32_TOL and abs(metric - ref_metric) <= F32_TOL
    assert err <= F32_TOL
    fps = data2[0]["dp/fp"]
    top = max(golden[f"trainer/d2s1/grad/{name}"][0] for name in fps)
    for name, fp in fps.items():
        gen.assert_fingerprint(fp, golden[f"trainer/d2s1/grad/{name}"], F32_TOL, name,
                               floor=1e-6 * top)


def test_data_parallel_gathered_loss_step(data2):
    """A data-2 step with LovaszLoss (logits and labels gathered, the loss
    of the whole batch, each rank's slice of its gradient) equals one
    process's step."""
    for r in data2:
        loss, ref_loss, metric, ref_metric, err = r["dp/LovaszLoss"]
        assert abs(loss - ref_loss) <= F32_TOL and abs(metric - ref_metric) <= F32_TOL
        assert err <= F32_TOL


def test_tensor_parallel_step(model2):
    """On model 2 the 32-channel bottleneck kernels are held sharded on
    their output channel (threshold lowered to 32 at this width); one SGD
    step equals one process's, each rank holding its slice."""
    for r in model2:
        assert r["tp/spec"] == {"bottleneck.bottleneckconv1.weight": 0,
                                "bottleneck.bottleneckconv2.weight": 0}
        loss, ref = r["tp/loss"]
        assert abs(loss - ref) <= F32_TOL and r["tp/err"] <= F32_TOL


def test_pipeline_matches_jax_and_sequential(model2, golden):
    """``pipeline_apply`` of 4 microbatches through 2 stages over the model
    axis: every rank holds JAX's outputs and ``sequential_reference``'s."""
    for r in model2:
        np.testing.assert_allclose(r["pipe/out"], golden["pipe/out"], atol=1e-6)
        np.testing.assert_allclose(r["pipe/out"], r["pipe/seq"], atol=1e-6)


def test_sharded_checkpoint_model2_to_one_process(model2):
    """A checkpoint both model ranks wrote (each its kernel shards and their
    momentum buffers) restores in one process whole, bit for bit."""
    from tpuseg_torch.core.checkpoint import read_meta_sharded, restore_sharded

    path = model2[0]["ckpt/path"]
    state = restore_sharded(path)
    spec = model2[0]["tp/spec"]
    for k, v in state["model"].items():
        want = (np.concatenate([r["ckpt/local"][k] for r in model2], axis=spec[k])
                if k in spec else model2[0]["ckpt/local"][k])
        assert np.array_equal(v.numpy(), want), k
    names = list(model2[0]["ckpt/local"])
    for i, st in state["optimizer"]["state"].items():
        for k, v in st.items():
            parts = [r["ckpt/local_moments"][f"{i}/{k}"] for r in model2]
            want = (np.concatenate(parts, axis=spec[names[i]])
                    if names[i] in spec and v.dim() else parts[0])
            assert np.array_equal(v.numpy(), want), (i, k)
    assert read_meta_sharded(path)["epoch"] == 1


def test_sharded_checkpoint_space2_to_data2(data2):
    """A checkpoint written by a data 1 x space 2 mesh restores onto a data
    2 mesh of the same world: model, optimizer state, step and meta equal."""
    assert all(all(r["ckpt/s2_to_d2"]) for r in data2)


def test_mesh_flags_and_one_process_path(tmp_path):
    """The mesh flags parse (no longer refused); one process at the default
    flags builds no mesh (the single-device path), and a mesh the world
    cannot hold raises."""
    from tpuseg_torch import train
    from tpuseg_torch.config import parse_cli

    cfg = parse_cli(["--train.mesh_data", "2", "--train.mesh_model", "1",
                     "--train.mesh_space", "2"])
    assert (cfg.train.mesh_data, cfg.train.mesh_space) == (2, 2)
    assert train.make_run_mesh(parse_cli([]), "cpu") == (None, "cpu")
    with pytest.raises(ValueError, match="world size 1"):
        train.make_run_mesh(cfg, "cpu")


def test_initialize_device_rules():
    """One process without torchrun's environment is world 1 on the
    caller's device; a rank without a card of its own raises unless the
    caller names the device."""
    from tpuseg_torch.core import distributed

    assert distributed.initialize("gloo", device="cpu") == (0, 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no card of its own"):
        distributed._default_device("nccl", torch.cuda.device_count())
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("mpi", rank=0, world_size=2)
