"""Multi-rank worlds for the port's parallel tests
(``tests/test_torch_port_parallel.py``, ``tests/test_torch_port_spatial.py``).

``run_world(job, tmp_dir)`` spawns a 2-rank gloo world on the CPU (one
thread a rank, rendezvous through a ``file://`` store under ``tmp_dir``, so
concurrent test workers never share a port), runs ``job(rank, tmp_dir)`` in
every rank and returns each rank's dict of numpy results; a failure in any
rank raises with its traceback.  The jobs compute everything a test file
asserts (the port's parallel path, the port's own single-process reference,
the fingerprints compared with ``tests/data/torch_port_parallel_golden.npz``)
once per world layout.  This module imports no JAX.
"""
from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
TIMEOUT_S = 600


def _gen():
    sys.path.insert(0, HERE)
    import make_torch_port_parallel_golden as gen

    return gen


def _child(rank: int, job: str, tmp_dir: str, queue) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        sys.path.insert(0, os.path.dirname(HERE))
        dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/store", rank=rank,
                                world_size=WORLD)
        try:
            out = JOBS[job](rank, tmp_dir)
        finally:
            dist.barrier()
            dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def run_world(job: str, tmp_dir: str) -> list:
    """Each rank's results of ``JOBS[job]`` in a fresh 2-rank gloo world."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_child, args=(r, job, str(tmp_dir), q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    results, errors, done = [None] * WORLD, [], set()
    t_end = time.monotonic() + TIMEOUT_S
    try:
        while len(done) < WORLD and not errors:
            try:
                rank, out, err = q.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > t_end:
                    errors.append(f"no result within {TIMEOUT_S} s")
                continue
            done.add(rank)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def unet(dtype=None, levels: int = 2, dropout: float = 0.0, classes: int = 3):
    """The golden file's UNet3d (features 8) with its seeded weights."""
    import torch

    from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
    from tpuseg_torch.models.unet import UNet

    gen = _gen()
    net = UNet(classes, features=gen.F, dropout=dropout, levels=levels)
    net.load_state_dict(unet_params_from_jax(
        seeded_unet_params(gen.SEED, gen.F, classes, 1, levels=levels), levels=levels),
        strict=True)
    return net.to(dtype or torch.float32)


def vnet(dtype=None):
    import torch

    from tpuseg_torch.compat.weights import vnet_params_from_jax
    from tpuseg_torch.models.vnet import VNet

    gen = _gen()
    net = VNet(gen.VNET_K, features=gen.F, dropout=0.0)
    net.load_state_dict(vnet_params_from_jax(gen.seeded_params("vnet")), strict=True)
    return net.to(dtype or torch.float32)


def fingerprints(named: dict) -> dict:
    gen = _gen()
    return {n: gen.fingerprint(g.detach().double().numpy()) for n, g in named.items()}


def rel_errors(got: dict, ref: dict, floor: float = 1e-6) -> float:
    """The worst max |got - ref| over max(max |ref|, floor x the largest)."""
    top = floor * max(float(r.abs().max()) for r in ref.values())
    return max(float((got[n] - r).abs().max()) / max(float(r.abs().max()), top, 1e-300)
               for n, r in ref.items())


def _zslab(t, rank: int, axis: int = 1):
    dz = t.shape[axis] // WORLD
    return t.narrow(axis, rank * dz, dz).contiguous()


def _step_grads(net, step):
    """The gradients one SGD update (lr 1, momentum 0.9) of ``step(opt)``
    took: its momentum buffers (0.9 x 0 + g)."""
    import torch

    opt = torch.optim.SGD(net.parameters(), lr=1.0, momentum=0.9)
    step(opt)
    return {n: opt.state[p]["momentum_buffer"].clone() for n, p in net.named_parameters()}


def _grads(module) -> dict:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


# ---------------------------------------------------------------------------
# space 2
# ---------------------------------------------------------------------------


def job_space2(rank: int, tmp_dir: str) -> dict:
    import torch

    from tpuseg_torch.core.mesh import MeshContext, make_mesh
    from tpuseg_torch.core.prng import step_generator
    from tpuseg_torch.kernels.fused_norm import (
        fused_group_norm_relu_plain, fused_group_norm_relu_split)
    from tpuseg_torch.losses import build_loss
    from tpuseg_torch.models.unet_packed import packed_unet3d_apply
    from tpuseg_torch.models.unet_packed_sp import packed_unet3d_apply_sp
    from tpuseg_torch.parallel.spatial import (
        halo_exchange, make_spatial_seg_train_step, spatial_grad_step, spatial_partition_infer,
        spatial_twin)
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.spatial import SpatialSegTrainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    gen = _gen()
    mesh = make_mesh(data=1, space=WORLD)
    g = mesh.group("space")
    out = {}

    # halo exchange, both boundaries
    x = torch.from_numpy(gen.inputs("halo"))
    for boundary in ("zero", "replicate"):
        out[f"halo/{boundary}"] = halo_exchange(_zslab(x, rank, 0), g, 2, boundary).numpy()

    # overlap-tile inference
    vol, w1, w2 = (torch.from_numpy(a) for a in gen.inputs("infer"))

    def conv(t, w):
        y = torch.nn.functional.conv3d(t.permute(3, 0, 1, 2)[None], w.permute(4, 3, 0, 1, 2),
                                       padding=1)
        return y[0].permute(1, 2, 3, 0)

    def apply_fn(t):
        return conv(torch.tanh(conv(t, w1)), w2)

    out["infer/out"] = spatial_partition_infer(vol.numpy(), apply_fn, g, margin=4).numpy()
    out["infer/plain"] = apply_fn(vol).numpy()

    # K1 split's plain version against the whole map's GroupNorm, f64
    rng = np.random.default_rng(20)
    full = torch.from_numpy(rng.standard_normal((2, 16, 4, 4, 16)) * 3 + 5).requires_grad_()
    gamma = torch.from_numpy(rng.standard_normal(16)).requires_grad_()
    beta = torch.from_numpy(rng.standard_normal(16)).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(full.shape))
    ref = fused_group_norm_relu_plain(full, gamma, beta, 8, 1e-6, True)
    (ref * cot).sum().backward()
    ref_g = [t.grad.clone() for t in (full, gamma, beta)]
    for t in (full, gamma, beta):
        t.grad = None
    xs = _zslab(full.detach(), rank).requires_grad_()
    y = fused_group_norm_relu_split(xs, gamma, beta, 8, 1e-6, True, g)
    (y * _zslab(cot, rank)).sum().backward()
    dgb = torch.cat([gamma.grad, beta.grad])
    from tpuseg_torch.core.distributed import all_reduce_sum

    dgb = all_reduce_sum(dgb, g)
    out["k1/err"] = np.array([
        float((y.detach() - _zslab(ref.detach(), rank)).abs().max()),
        float((xs.grad - _zslab(ref_g[0], rank)).abs().max()),
        float((dgb - torch.cat(ref_g[1:])).abs().max())])

    # spatial_grad_step of both twins in f64, against JAX and one process
    for net_name, make in (("unet", lambda: unet(torch.float64)), ("vnet",
                                                                    lambda: vnet(torch.float64))):
        xi, yi = (torch.from_numpy(a) for a in gen.inputs(net_name))
        net = make()
        lg, _ = net(xi)
        ref_loss = ((lg - yi) ** 2).sum()
        ref_loss.backward()
        ref_grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        net.zero_grad()
        loss, grads = spatial_grad_step(spatial_twin(net, g), _zslab(xi, rank), _zslab(yi, rank))
        out[f"grad_{net_name}64/value"] = np.array([float(loss), float(ref_loss)])
        out[f"grad_{net_name}64/fp"] = fingerprints(grads)
        out[f"grad_{net_name}64/single_err"] = rel_errors(grads, ref_grads)

    # the seven losses: one z-sharded SGD step each, against JAX and one process
    image, label = (torch.from_numpy(a) for a in gen.inputs("loss"))
    for name in gen.SPATIAL_LOSS_NAMES:
        net = unet()
        res = {}

        def sharded(opt):
            step = make_spatial_seg_train_step(spatial_twin(net, g), opt, name, alpha=[1.0] * 3,
                                               train=False)
            res["loss"] = float(step(_zslab(image, rank), _zslab(label.long(), rank), 0))

        delta = _step_grads(net, sharded)
        ref_net = unet()
        loss_fn = build_loss(name, 3, alpha=[1.0] * 3)

        def single(opt):
            lg, _ = ref_net(image)
            loss = loss_fn(lg.float(), label.long())
            opt.zero_grad()
            loss.backward()
            opt.step()
            res["ref"] = float(loss)

        ref_delta = _step_grads(ref_net, single)
        out[f"loss/{name}/loss"] = np.array([res["loss"], res["ref"]])
        out[f"loss/{name}/fp"] = fingerprints(delta)
        out[f"loss/{name}/single_err"] = rel_errors(delta, ref_delta)

    # the spatial trainer's step (data 1 x space 2), SGD at lr 1, against JAX
    image, label = gen.inputs("train")
    trainer = make_segmentation_trainer(
        unet(), 3, "MutilDiceLoss", alpha=[1.0] * 3,
        config=TrainerConfig(lr=1.0, optimizer="sgd"), device="cpu", mesh=MeshContext(mesh))
    assert isinstance(trainer, SpatialSegTrainer)
    m = trainer.train_step(trainer._put(trainer.shard_batch(
        {"image": image, "label": label.astype(np.int64)})))
    out["trainer/d1s2/loss"] = np.array([float(m["loss"]), float(m["metric"])])
    out["trainer/d1s2/fp"] = fingerprints(_grads(trainer.model))

    # with dropout on, the z-sharded f64 step is one process's step
    xi, yi = (torch.from_numpy(a) for a in gen.inputs("unet"))
    net = unet(torch.float64, dropout=0.3)
    net.train()
    lg, _ = net(xi, step_generator(7, 3, "cpu"))
    ((lg - yi) ** 2).sum().backward()
    ref_grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    _, grads = spatial_grad_step(spatial_twin(net, g), _zslab(xi, rank), _zslab(yi, rank),
                                 train=True, generator=step_generator(7, 3, "cpu"))
    out["dropout/err"] = rel_errors(grads, ref_grads, floor=0.0)

    # packed x spatial: f32 forward and f64 gradients
    xp, cotp = (torch.from_numpy(a) for a in gen.inputs("packed"))
    net = unet()
    with torch.no_grad():
        lg, pr = packed_unet3d_apply_sp(net, _zslab(xp, rank), g)
        lg_ref, pr_ref = packed_unet3d_apply(net, xp)
    out["packed_sp/logits"], out["packed_sp/probs"] = lg.numpy(), pr.numpy()
    out["packed_sp/single_err"] = max(float((lg - _zslab(lg_ref, rank)).abs().max()),
                                      float((pr - _zslab(pr_ref, rank)).abs().max()))
    net = unet(torch.float64)
    lg, pr = packed_unet3d_apply(net, xp.double())
    v_ref = (lg * cotp).sum() + (pr * pr).sum()
    v_ref.backward()
    ref_grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    lg, pr = packed_unet3d_apply_sp(net, _zslab(xp.double(), rank), g)
    ((lg * _zslab(cotp, rank)).sum() + (pr * pr).sum()).backward()
    from tpuseg_torch.parallel.spatial import psum, sum_grads_

    sum_grads_(net.parameters(), g)
    grads = {n: p.grad for n, p in net.named_parameters()}
    v = psum((lg.detach() * _zslab(cotp, rank)).sum() + (pr.detach() ** 2).sum(), g)
    out["packed_sp64/value"] = np.array([float(v), float(v_ref)])
    out["packed_sp64/fp"] = fingerprints(grads)
    out["packed_sp64/single_err"] = rel_errors(grads, ref_grads)

    # refusals
    from tpuseg_torch.models.vnet import VNet

    refused = []
    for kw in ({"loss_name": "LovaszLoss"}, {"packed_stem": True, "model": VNet(2, 8)}):
        try:
            make_segmentation_trainer(kw.get("model", unet()), 3,
                                      kw.get("loss_name", "MutilDiceLoss"), device="cpu",
                                      mesh=MeshContext(mesh),
                                      packed_stem=kw.get("packed_stem", False))
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused

    # a spatial run's checkpoint (UNet3d at its default levels), for serve
    from tpuseg_torch.models.unet import UNet

    rng = np.random.default_rng(30)
    net = UNet(2, features=8, dropout=0.2, generator=torch.Generator().manual_seed(0))
    trainer = make_segmentation_trainer(net, 2, "MutilCrossEntropyDiceLoss",
                                        config=TrainerConfig(epochs=1, optimizer="adam"),
                                        device="cpu", mesh=MeshContext(mesh))
    batch = {"image": rng.standard_normal((1, 32, 16, 16, 1)).astype(np.float32),
             "label": rng.integers(0, 2, (1, 32, 16, 16)).astype(np.int64)}
    run_dir = os.path.join(tmp_dir, "spatial_run")
    trainer.fit(lambda: iter([batch, batch]), lambda: iter([batch]), run_dir)
    out["run/dir"] = run_dir
    out["run/state"] = {k: v.numpy() for k, v in net.state_dict().items()}
    return out


# ---------------------------------------------------------------------------
# data 2 (and a space-2 mesh of the same world, for the checkpoint)
# ---------------------------------------------------------------------------


def _dp_step(mesh, loss_name: str):
    """(loss, metric, gradients) of one SGD (lr 1) step of the golden UNet on
    the golden training batch; ``mesh`` None: one process."""
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    image, label = _gen().inputs("train")
    trainer = make_segmentation_trainer(unet(), 3, loss_name, alpha=[1.0] * 3,
                                        config=TrainerConfig(lr=1.0, optimizer="sgd"),
                                        device="cpu", mesh=mesh)
    m = trainer.train_step(trainer._put(trainer.shard_batch(
        {"image": image, "label": label.astype(np.int64)})))
    return float(m["loss"]), float(m["metric"]), _grads(trainer.model)


def job_data2(rank: int, tmp_dir: str) -> dict:
    import torch

    from tpuseg_torch.core import checkpoint as ckpt
    from tpuseg_torch.core import distributed
    from tpuseg_torch.core.mesh import MeshContext, make_mesh
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    mesh = make_mesh(data=-1)
    out = {"mesh/shape": mesh.shape, "mesh/coords": mesh.coords,
           "mesh/data_ranks": mesh.group("data").ranks,
           "mesh/space_ranks": mesh.group("space").ranks,
           "host_shard": distributed.host_shard(), "primary": distributed.is_primary()}
    for name in ("MutilDiceLoss", "LovaszLoss"):
        loss, metric, delta = _dp_step(MeshContext(mesh), name)
        ref_loss, ref_metric, ref_delta = _dp_step(None, name)
        out[f"dp/{name}"] = np.array([loss, ref_loss, metric, ref_metric,
                                      rel_errors(delta, ref_delta)])
        if name == "MutilDiceLoss":
            out["dp/fp"] = fingerprints(delta)

    # a checkpoint written on data 1 x space 2, restored on data 2
    rng = np.random.default_rng(40)
    batch = {"image": rng.standard_normal((2, 16, 8, 8, 1)).astype(np.float32),
             "label": rng.integers(0, 3, (2, 16, 8, 8)).astype(np.int64)}
    sp = make_segmentation_trainer(unet(), 3, "MutilDiceLoss", alpha=[1.0] * 3,
                                   config=TrainerConfig(optimizer="adam"), device="cpu",
                                   mesh=MeshContext(make_mesh(data=1, space=WORLD)))
    sp.train_step(sp._put(sp.shard_batch(batch)))
    path = os.path.join(tmp_dir, "ckpt_s2")
    ckpt.save_sharded(path, sp.state_dict(), {"step": sp.step})
    dp = make_segmentation_trainer(unet(), 3, "MutilDiceLoss", alpha=[1.0] * 3,
                                   config=TrainerConfig(optimizer="adam"), device="cpu",
                                   mesh=MeshContext(mesh))
    dp.train_step(dp._put(dp.shard_batch(batch)))  # so that it has state of its own
    dp.load_state_dict(ckpt.restore_sharded(path))
    saved, got = sp.state_dict(), dp.state_dict()
    same = all(torch.equal(saved["model"][k], got["model"][k]) for k in saved["model"])
    same &= all(torch.equal(a[k], b[k]) for i, a in saved["optimizer"]["state"].items()
                for b in [got["optimizer"]["state"][i]] for k in a)
    out["ckpt/s2_to_d2"] = [same, got["step"] == saved["step"],
                            ckpt.read_meta_sharded(path) == {"step": 1}]
    return out


# ---------------------------------------------------------------------------
# model 2 (tensor parallel) and the pipeline over the model axis
# ---------------------------------------------------------------------------


def job_model2(rank: int, tmp_dir: str) -> dict:
    import torch

    from tpuseg_torch.core.mesh import MeshContext, make_mesh
    from tpuseg_torch.parallel.pipeline import pipeline_apply, sequential_reference
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    gen = _gen()
    mesh = make_mesh(data=1, model=WORLD)
    out = {"mesh/model_ranks": mesh.group("model").ranks}

    # one tensor-parallel SGD step (kernels of >= 32 output channels
    # sharded): its gradients against one process's
    image, label = gen.inputs("train")
    batch = {"image": image, "label": label.astype(np.int64)}

    def step(m):
        tr = make_segmentation_trainer(
            unet(), 3, "MutilDiceLoss", alpha=[1.0] * 3, device="cpu", mesh=m,
            config=TrainerConfig(optimizer="sgd", lr=1.0, model_axis_min_size=32))
        loss = tr.train_step(tr._put(tr.shard_batch(batch)))["loss"]
        return tr, float(loss), _grads(tr.model)

    tp, loss, delta = step(MeshContext(mesh))
    ref, ref_loss, ref_delta = step(None)
    for n, d in tp.tp_spec.items():
        k = delta[n].shape[d]
        ref_delta[n] = ref_delta[n].narrow(d, rank * k, k)
    out["tp/spec"] = dict(tp.tp_spec)
    out["tp/loss"] = np.array([loss, ref_loss])
    out["tp/err"] = rel_errors(delta, ref_delta)

    # the sharded checkpoint, written by both ranks
    path = os.path.join(tmp_dir, "ckpt_m2")
    manager = tp._checkpoints(path)
    manager.save_latest(tp.state_dict(), tp.step, 0.5, epoch=1)
    sd = tp.state_dict()
    out["ckpt/path"] = os.path.join(path, "latest")
    out["ckpt/local"] = {k: v.numpy() for k, v in sd["model"].items()}
    out["ckpt/local_moments"] = {f"{i}/{k}": v.numpy()
                                 for i, st in sd["optimizer"]["state"].items()
                                 for k, v in st.items()}

    # GPipe over the model axis
    w, b, mb = (torch.from_numpy(a) for a in gen.inputs("pipe"))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out["pipe/out"] = pipeline_apply(stage_fn, {"w": w, "b": b}, mb, mesh.group("model")).numpy()
    out["pipe/seq"] = sequential_reference(stage_fn, {"w": w, "b": b}, mb).numpy()
    return out


JOBS = {"space2": job_space2, "data2": job_data2, "model2": job_model2}
