"""The port's z-sharded (space-parallel) paths against the JAX package and
against the port's own single-process computation: the halo exchange, the
overlap-tile forward, K1 split's plain version, the spatial twins of UNet3d
and VNet3d (``parallel/spatial.py``), the seven shard-decomposable losses,
the spatial trainer, and the packed x spatial UNet3d
(``models/unet_packed_sp.py``).

One 2-rank gloo world on the CPU (``tests/torch_port_ranks.py``, spawned
once for the module) computes every result; the JAX references come from
``tests/data/torch_port_parallel_golden.npz``
(``tests/make_torch_port_parallel_golden.py``).  Tolerances: float64 within
1e-8 of the scale, float32 within 1e-4.
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

F64_TOL, F32_TOL = 1e-8, 1e-4


@pytest.fixture(scope="module")
def golden():
    with np.load(gen.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_port_ranks.run_world("space2", str(tmp_path_factory.mktemp("space2")))


def _cat(world, key, axis=0):
    return np.concatenate([r[key] for r in world], axis=axis)


def _grads_match(world, golden, case: str, tol: float, fps=None) -> None:
    """Each parameter's gradient fingerprint against JAX's, scales floored at
    1e-6 of the largest gradient's."""
    fps = world[0][f"{case}/fp"] if fps is None else fps
    top = max(golden[f"{case}/grad/{name}"][0] for name in fps)
    for name, fp in fps.items():
        gen.assert_fingerprint(fp, golden[f"{case}/grad/{name}"], tol, f"{case} {name}",
                               floor=1e-6 * top)


def test_halo_exchange_both_boundaries(world, golden):
    """Each rank's halo'd shard equals JAX's (zero and replicate ends)."""
    for boundary in ("zero", "replicate"):
        got = np.stack([r[f"halo/{boundary}"] for r in world])
        np.testing.assert_array_equal(got, golden[f"halo/{boundary}"])


def test_spatial_partition_infer(world, golden):
    """The clamped-window overlap-tile forward equals JAX's and, with the
    margin above the receptive field, the unsharded forward."""
    scale = np.abs(golden["infer/plain"]).max()
    for r in world:
        assert np.abs(r["infer/out"] - golden["infer/out"]).max() <= F32_TOL * scale
        assert np.abs(r["infer/out"] - r["infer/plain"]).max() <= F32_TOL * scale


def test_k1_split_plain_equals_whole_map_group_norm(world):
    """K1 split's plain version (the JAX formula over the ranks' sums) on
    two z-halves of a map with a large mean: the output, dx and the summed
    dgamma / dbeta of the whole map's GroupNorm+ReLU, in float64."""
    assert max(max(r["k1/err"]) for r in world) <= 1e-9


@pytest.mark.parametrize("net", ["unet", "vnet"])
def test_spatial_twin_grad_step_f64(world, golden, net):
    """``spatial_grad_step`` of SpatialUNet3d / SpatialVNet3d in float64:
    the loss and every parameter gradient equal JAX's and the plain net's
    one-process gradients."""
    value, ref = world[0][f"grad_{net}64/value"]
    assert abs(value - golden[f"grad_{net}64/value"]) <= F64_TOL * abs(ref)
    assert abs(value - ref) <= F64_TOL * abs(ref)
    _grads_match(world, golden, f"grad_{net}64", F64_TOL)
    assert world[0][f"grad_{net}64/single_err"] <= F64_TOL


def test_seven_losses_sharded_step(world, golden):
    """``make_spatial_seg_train_step`` for every ``SPATIAL_LOSS_NAMES``
    loss: the global loss and the SGD update (the gradient) equal JAX's
    and one process's (``build_loss`` on the whole volume), float32."""
    for name in gen.SPATIAL_LOSS_NAMES:
        loss, ref = world[0][f"loss/{name}/loss"]
        assert world[1][f"loss/{name}/loss"][0] == loss
        assert abs(loss - golden[f"loss/{name}/loss"]) <= F32_TOL * max(1.0, abs(loss)), name
        assert abs(loss - ref) <= F32_TOL * max(1.0, abs(ref)), name
        _grads_match(world, golden, f"loss/{name}", F32_TOL,
                     fps=world[0][f"loss/{name}/fp"])
        assert world[0][f"loss/{name}/single_err"] <= F32_TOL, name


def test_spatial_trainer_step_matches_jax(world, golden):
    """One step of ``make_segmentation_trainer`` on data 1 x space 2 (the
    spatial trainer, MutilDiceLoss, SGD at lr 1): loss, metric and update
    equal the JAX trainer's on the same mesh."""
    loss, metric = world[0]["trainer/d1s2/loss"]
    assert abs(loss - golden["trainer/d1s2/loss"]) <= F32_TOL
    assert abs(metric - golden["trainer/d1s2/metric"]) <= F32_TOL
    _grads_match(world, golden, "trainer/d1s2", F32_TOL)


def test_spatial_step_with_dropout_equals_one_process(world):
    """With dropout on (rate 0.3), the z-sharded float64 step's gradients
    equal the plain net's step with the same generator: every rank draws
    the same channel masks."""
    assert max(r["dropout/err"] for r in world) <= 1e-6


def test_packed_spatial_forward(world, golden):
    """``packed_unet3d_apply_sp`` over two z-shards: logits and probs equal
    JAX's and the port's unsharded packed twin's, float32."""
    lg, pr = _cat(world, "packed_sp/logits", 1), _cat(world, "packed_sp/probs", 1)
    scale = max(1.0, np.abs(golden["packed_sp/logits"]).max())
    assert np.abs(lg - golden["packed_sp/logits"]).max() <= F32_TOL * scale
    assert np.abs(pr - golden["packed_sp/probs"]).max() <= F32_TOL
    assert max(r["packed_sp/single_err"] for r in world) <= F32_TOL * scale


def test_packed_spatial_grads_f64(world, golden):
    """The packed x spatial forward's float64 gradients (of sum(logits *
    cot) + sum(probs^2)) equal JAX's and the unsharded packed twin's."""
    value, ref = world[0]["packed_sp64/value"]
    assert abs(value - golden["packed_sp64/value"]) <= F64_TOL * abs(ref)
    _grads_match(world, golden, "packed_sp64", F64_TOL)
    assert world[0]["packed_sp64/single_err"] <= F64_TOL


def test_twins_hold_the_plain_state_dict():
    """A SpatialUNet3d / SpatialVNet3d state_dict loads strictly into the
    plain UNet / VNet and back: the same keys and tensors."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.parallel.spatial import spatial_twin

    for make in (lambda: UNet(3, features=8, levels=2), lambda: VNet(2, features=8)):
        a, b = make(), make()
        twin = spatial_twin(a)
        assert list(twin.state_dict()) == list(a.state_dict())
        b.load_state_dict(twin.state_dict(), strict=True)
        twin.load_state_dict(b.state_dict(), strict=True)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in twin.state_dict().items())


def test_spatial_run_serves_unchanged(world):
    """A checkpoint the spatial trainer writes (UNet3d, data 1 x space 2,
    one epoch; the primary rank writes) serves through
    ``tpuseg_torch.serve`` with the trained weights."""
    from tpuseg_torch import serve
    from tpuseg_torch.config import parse_cli

    r0 = world[0]
    cfg = parse_cli(["--infer.model_dir", r0["run/dir"], "--model.features", "8",
                     "--model.num_classes", "2", "--infer.new_size", "[16,16,32]"])
    model = serve.build_model(cfg, device="cpu")
    assert all(np.array_equal(v.numpy(), r0["run/state"][k])
               for k, v in model.model.state_dict().items())


def test_spatial_refusals(world):
    """A loss outside SPATIAL_LOSS_NAMES and packed_stem on a VNet with
    space > 1 raise, as in JAX."""
    refused = world[0]["refused"]
    assert len(refused) == 2 and "shard-decomposable" in refused[0]
    assert "packed_stem with space>1" in refused[1]
