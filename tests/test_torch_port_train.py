"""The port's training slice (tpuseg_torch) against the JAX package.

UNet3d at features 8, 3 classes, 16^3 input, weights from
``seeded_unet_params``, dropout 0 (torch and JAX draw different dropout
bits): the same numpy-seeded weights, volumes and labels go through the JAX
trainer's loss and optimizer and through the port's, on the CPU, in f32.
The JAX train step of the 4-level net is read from the golden file, which
``test_golden_file_is_current`` keeps equal to the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.core import optim as jax_optim
from tpuseg.data.dataset import read_manifest_csv as jax_read_manifest_csv
from tpuseg.losses import build_loss as jax_build_loss
from tpuseg.metrics import multiclass_dice_coeff as jax_multiclass_dice
from tpuseg.models.unet import UNet as JUNet
from tpuseg.tasks.trainer import Trainer as JTrainer
from tpuseg.tasks.trainer import TrainerConfig as JTrainerConfig
from tpuseg_torch import losses as port_losses
from tpuseg_torch.compat.seg_models import MutilUNet3dModel
from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
from tpuseg_torch.core.checkpoint import CheckpointManager
from tpuseg_torch.core.optim import make_optimizer
from tpuseg_torch.core.prng import step_generator
from tpuseg_torch.data.dataset import read_manifest_csv
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

F, K, S = 8, 3, 16  # features, classes, cube side
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = [1.0] * K


def _batches(n, seed=10):
    """n seeded (image, label) batches of one 16^3 volume each."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((1, S, S, S, 1)).astype(np.float32),
             "label": rng.integers(0, K, (1, S, S, S)).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def params():
    return seeded_unet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def golden():
    """The JAX trainer's loss, metric and every gradient of one f32 step on
    the golden train batch, as tests/make_torch_port_golden.py stored them
    (test_golden_file_is_current recomputes them with the JAX package)."""
    g = np.load(os.path.join(REPO, "tests", "data", "torch_port_golden.npz"))
    assert (int(g["features"]), int(g["num_classes"]), int(g["seed"])) == (F, K, 0)
    assert g["train_x"].shape == (1, S, S, S, 1)
    return {k: g[k] for k in g.files}


def _jax_trainer_parts(levels):
    """apply/loss/metric exactly as tpuseg's make_segmentation_trainer
    builds them on the plain path (no model.init: the weights are given)."""
    model = JUNet(ndim=3, num_classes=K, features=F, dropout=0.0, levels=levels)
    loss = jax_build_loss("MutilDiceLoss", K, alpha=ALPHA)

    def apply_fn(p, batch, train, rng):
        rngs = {"dropout": rng} if (train and rng is not None) else None
        logits, probs = model.apply(p, batch["image"], train=train, rngs=rngs)
        return {"logits": logits, "probs": probs}

    def loss_fn(outputs, batch):
        return loss(outputs["logits"], batch["label"])

    def metric_fn(outputs, batch):
        return jax_multiclass_dice(outputs["probs"], batch["label"])

    return apply_fn, loss_fn, metric_fn


def _port_trainer(params, levels=4, **cfg):
    model = UNet(K, F, dropout=0.0, levels=levels)
    model.load_state_dict(unet_params_from_jax(params, levels=levels), strict=True)
    config = TrainerConfig(optimizer="adam", lr=1e-3, **cfg)
    return make_segmentation_trainer(model, K, "MutilDiceLoss", alpha=ALPHA,
                                     config=config, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_step_matches_jax_value_and_grad(params, golden):
    """Loss within 1e-5; every parameter grad within 1e-4 * max(1, max |g_jax|)
    and within 1e-4 of its own max |g_jax| (the gradients here are all below
    1; f32 convs and reductions summed in another order)."""
    trainer = _port_trainer(params)
    m = trainer.train_step({"image": torch.from_numpy(golden["train_x"]),
                            "label": torch.from_numpy(golden["train_label"])})
    assert abs(float(m["loss"]) - float(golden["train_loss"])) <= 1e-5
    assert abs(float(m["metric"]) - float(golden["train_metric"])) <= 1e-5
    ref = {k[len("grad/"):]: torch.from_numpy(v) for k, v in golden.items()
           if k.startswith("grad/")}
    got = dict(trainer.model.named_parameters())
    assert set(ref) == set(got)
    for name, g in ref.items():
        mag = float(g.abs().max())
        err = float((got[name].grad - g).abs().max())
        assert err <= 1e-4 * min(max(1.0, mag), mag), (name, err, mag)


def test_three_fit_steps_match_the_jax_trainer(tmp_path):
    """The port's fit (3 Adam steps, one epoch) against the JAX Trainer's
    jitted train step on the same 3 batches: the epoch's mean train loss
    within 1e-4 (after Adam steps, components whose gradient is at rounding
    level may move by up to lr in either framework).  A 1-level UNet, to
    cut the JAX compile; the 4-level net's step is held to JAX above."""
    batches = _batches(3, seed=11)
    params = seeded_unet_params(0, F, K, 1, levels=1)
    jt = JTrainer(*_jax_trainer_parts(1), {"params": params},
                  JTrainerConfig(optimizer="adam", lr=1e-3, donate_state=False))
    jt._build_steps()
    state, jlosses = jt.state, []
    for b in batches:
        state, m = jt._train_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
    trainer = _port_trainer(params, levels=1, epochs=1)
    history = trainer.fit(lambda: iter(batches), lambda: iter(batches[:1]),
                          str(tmp_path))
    assert trainer.step == 3
    assert abs(history["train_loss"][0] - float(np.mean(jlosses))) <= 1e-4


def test_adam_update_matches_jax_scale_by_adam():
    """torch.optim.Adam (the port's "adam") against tpuseg.core.optim.adam
    on identical grads over 3 steps: parameters within 1e-6."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = jax_optim.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer("adam", tp.values(), 1e-3)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax_optim.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_checkpoint_round_trip_and_resume(params, tmp_path):
    """best/ and latest/ hold the model, the Adam moments, the step, the
    epoch and the seed; a second fit with resume=True starts at the saved
    epoch with the saved step and moments, and draws the saved seed's
    dropout streams."""
    batches = _batches(2, seed=12)
    first = _port_trainer(params, epochs=1, seed=7)
    first.fit(lambda: iter(batches), lambda: iter(batches[:1]), str(tmp_path))
    for name in ("best", "latest"):
        assert sorted(os.listdir(tmp_path / name)) == ["meta.json", "state.pt"]
    state, meta = CheckpointManager(str(tmp_path)).restore("latest")
    assert meta["epoch"] == 1 and meta["step"] == 2 and state["seed"] == 7
    for k, v in first.model.state_dict().items():
        torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)

    second = _port_trainer(seeded_unet_params(1, F, K, 1), epochs=2)
    seen = {}
    step = second.train_step

    def spy(batch):
        if not seen:
            seen["step"] = second.step
            seen["seed"] = second.config.seed
            seen["moments"] = [second.optimizer.state[p]["exp_avg"].clone()
                               for p in second.model.parameters()]
        return step(batch)

    second.train_step = spy
    history = second.fit(lambda: iter(batches), lambda: iter(batches[:1]),
                         str(tmp_path), resume=True)
    assert len(history["train_loss"]) == 1 and second.step == 4
    assert seen["step"] == 2 and seen["seed"] == 7
    for p, m in zip(first.model.parameters(), seen["moments"]):
        torch.testing.assert_close(first.optimizer.state[p]["exp_avg"], m,
                                   rtol=0, atol=0)
    assert CheckpointManager(str(tmp_path)).restore("latest")[1]["epoch"] == 2


def test_checkpoint_restore_falls_back_to_old(tmp_path):
    """A crash between moving the old checkpoint aside and swapping the new
    one in leaves only `<name>.old`; restore reads it."""
    manager = CheckpointManager(str(tmp_path))
    manager.save_latest({"x": torch.arange(3)}, step=5, epoch=1)
    os.replace(tmp_path / "latest", tmp_path / "latest.old")
    state, meta = manager.restore("latest")
    assert meta["step"] == 5 and state["x"].tolist() == [0, 1, 2]


def test_fit_resilient_restarts_from_latest_then_load_and_predict(tmp_path):
    """A failure in the second epoch restarts fit from latest/ (epoch 1,
    step 2), which then finishes; load("best") and predict_batch serve the
    saved weights in eval mode."""
    batches = _batches(2, seed=14)
    trainer = _port_trainer(seeded_unet_params(0, F, K, 1, levels=2), levels=2,
                            epochs=2)
    calls = []

    def train_batches():
        calls.append(trainer.step)
        if len(calls) == 2:
            raise RuntimeError("lost the device")
        return iter(batches)

    history = trainer.fit_resilient(train_batches, lambda: iter(batches[:1]),
                                    str(tmp_path), max_restarts=1)
    assert calls == [0, 2, 2] and trainer.step == 4
    assert len(history["train_loss"]) == 1  # the restarted run did epoch 2 only
    meta = trainer.load(str(tmp_path), "best")
    out = trainer.predict_batch(batches[0])
    assert out["outputs"]["probs"].shape == (1, S, S, S, K)
    assert float(out["loss"]) < 0 and meta["step"] in (2, 4)


def test_step_generators_are_per_step_and_reproducible():
    a = torch.rand(4, generator=step_generator(0, 3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=step_generator(0, 3, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(0, 4, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(1, 3, "cpu")))


def test_dropout_follows_the_step_generator():
    """Training-mode forwards with the same step generator agree; eval
    ignores it."""
    model = UNet(K, F, dropout=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_batches(1)[0]["image"])
    model.train()
    with torch.no_grad():
        a = model(x, step_generator(0, 0, "cpu"))[0]
        b = model(x, step_generator(0, 0, "cpu"))[0]
        c = model(x, step_generator(0, 1, "cpu"))[0]
        model.eval()
        d = model(x, step_generator(0, 0, "cpu"))[0]
        e = model(x)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)


@pytest.mark.parametrize("name", [
    "MutilDiceLoss", "MutilCrossEntropyLoss", "MutilFocalLoss", "MutilTverskyLoss",
    "BinaryDiceLoss", "BinaryCrossEntropyDiceLoss",
    "MutilCrossEntropyDiceLoss", "MutilELDiceLoss", "MutilSSLoss",
    "BinaryJaccardLoss", "BinaryELDiceLoss", "BinarySSLoss", "BinaryTverskyLoss",
    "BinaryCrossEntropyLoss", "BinaryFocalLoss", "MCCLoss"])
def test_losses_match_jax(name):
    """Loss values within 1e-5 on seeded logits and labels, for every name
    the port's ``build_loss`` takes.  ``MCCLoss`` is fed the logits by both
    trainers, which its square root does not survive (ROADMAP §3, an
    inherited defect): it passes when both packages agree within 1e-5 or
    both give NaN."""
    rng = np.random.default_rng(6)
    binary = name.startswith("Binary") or name == "MCCLoss"
    c = 1 if binary else K
    logits = (rng.standard_normal((2, 6, 5, 4, c)) * 2).astype(np.float32)
    labels = (rng.integers(0, 2, (2, 6, 5, 4, 1)).astype(np.float32) if binary
              else rng.integers(0, K, (2, 6, 5, 4)).astype(np.int32))
    alpha = None if binary else ALPHA
    ref = jax_build_loss(name, c, alpha=alpha)(jnp.asarray(logits), jnp.asarray(labels))
    got = port_losses.build_loss(name, c, alpha=alpha)(torch.from_numpy(logits),
                                                       torch.from_numpy(labels))
    if name == "MCCLoss" and np.isnan(float(ref)):
        assert np.isnan(float(got))
    else:
        assert abs(float(got) - float(ref)) <= 1e-5


def test_unported_losses_raise():
    """Every name of the JAX registry is ported; a name outside it raises."""
    for name in ("NoSuchLoss", "SSIMLoss"):
        with pytest.raises(KeyError, match="unknown loss name"):
            port_losses.build_loss(name, K)


def test_read_manifest_csv_matches_jax(tmp_path):
    path = tmp_path / "train.csv"
    path.write_text("Image,Mask\n/data/a img.npy,/data/a mask.npy\n"
                    "/data/b.npy,/data/b_mask.npy\n")
    assert read_manifest_csv(str(path)) == tuple(
        list(v) for v in jax_read_manifest_csv(str(path)))


def test_trainprocess_writes_checkpoints_and_curves(tmp_path):
    """The compat Model's trainprocess on .npy files: best/ and latest/,
    the two curves and a trained model left in eval mode."""
    rng = np.random.default_rng(13)
    paths = []
    for i in range(3):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal((S, S, S)).astype(np.float32))
        np.save(lab, rng.integers(0, K, (S, S, S)).astype(np.uint8))
        paths.append((str(img), str(lab)))
    model = MutilUNet3dModel(S, S, S, 1, K, 1, loss_name="MutilDiceLoss",
                             features=F, device="cpu")
    out = tmp_path / "run"
    history = model.trainprocess([p[0] for p in paths[:2]], [p[1] for p in paths[:2]],
                                 [paths[2][0]], [paths[2][1]], str(out), epochs=1)
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert {"best", "latest"} <= set(os.listdir(out))
    assert any(f.startswith("loss.") for f in os.listdir(out))
    assert not model.model.training and model.trainer.step == 2
