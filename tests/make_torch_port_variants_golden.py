"""Write tests/data/torch_port_variants_golden.npz: what the JAX package
computes for the opt-in variants, which ``tests/test_torch_port_variants.py``
holds the port to without running JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_variants_golden.py

It takes a few minutes on one core (the float64 gradients of the packed
twins compile for tens of seconds each).  Rerun it when ``tpuseg/`` changes
what it computes.  Inputs and weights come from numpy seeds (``x_of``,
``w_of``) and the seeded trees of ``compat/weights.py``, so the tests remake
them.  Cases, at the sizes of the JAX package's own tests:

* ``conv/<case>``: ``tpuseg.nn.layers.ConvND`` under ``int8_inference()``
  (``CONV_CASES``: 2D and 3D, kernels 1, 2, 3 and 7, strides 1 and 2, SAME
  and VALID): its output and the int8 operands and int32 sums that its
  ``lax.conv_general_dilated`` saw (recorded by a wrapper of that function).
* ``net/<case>``: the int8 nets (``NET_CASES``): VNet features 8 on 1x16^3
  under ``int8_inference()`` (``tests/test_int8.py``'s setting), the packed
  VNet twin (features 16, 1x32^3, packed_levels 1 and 2) and the packed UNet
  twin (features 16, 3 classes, 1x16^3) under ``int8_packed_inference()``:
  the int8 mask, the float net's logits, and every int8 conv site in call order
  (input and weight shapes, strides, (low, high) pads, a checksum of the
  int8 weight).
* ``fast/<case>``: ``ConvND`` / ``ConvTransposeND`` with
  ``use_gemm_fastpath=True`` (their ``kernel_s2d`` / ``kernel_d2s`` trees),
  the odd-size fallback, and a VNet (features 8, 1x16^3) run under
  ``USE_GEMM_FASTPATH`` from ``fast_vnet_tree``, whose tree the port
  carries.

Large outputs are kept as ``PT.fingerprint``s (the logits the tests hold
at 1e-5), and the int8 nets' masks (their bars are masks).
* ``shift/...``: ``packed_k3_conv`` in the shift-stack form on three axis
  sets and on a two-part concat, its weight gradient, the packed VNet
  (levels 1, 2) and UNet forwards under ``USE_SHIFT_PACKED_K3``, and the
  float64 gradients of the twins under it (``tests/make_torch_port_
  packed_train_golden.py``'s cases and fingerprints).
* ``k4s2/l{1,2}``: the packed VNet under ``LUCONV96_MODE = "k4s2"``.
* ``loss/...``: each class-major packed loss's value and gradient by the
  logits, and the packed dice / IoU metrics (``tests/test_packed_class_
  losses.py``'s data), a missing class too.
* ``step/{class,grid}``: one packed UNet3d trainer step (features 16, 5
  classes, 1x16^3, MutilDiceLoss) with ``USE_PACKED_CLASS_LOSS`` /
  ``USE_PACKED_GRID_LOSS``: loss, metric, gradient fingerprints.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_variants_golden.npz")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# fingerprints, seeded trees and the packed twins' x64 cases
PT = _load("make_torch_port_packed_train_golden")

# name: (ndim, x shape, kernel, stride, padding, Cout)
CONV_CASES = {
    "c3_k3s1_same": (3, (2, 5, 6, 7, 12), 3, 1, "SAME", 6),
    "c3_k3s2_same": (3, (2, 5, 6, 7, 12), 3, 2, "SAME", 6),
    "c3_k3s1_valid": (3, (1, 5, 6, 7, 16), 3, 1, "VALID", 18),
    "c3_k2s2_valid": (3, (1, 6, 4, 8, 20), 2, 2, "VALID", 5),
    "c3_k2s1_same": (3, (1, 5, 4, 6, 9), 2, 1, "SAME", 7),
    "c3_k1s1_same": (3, (2, 3, 4, 5, 32), 1, 1, "SAME", 40),
    "c3_k1s2_valid": (3, (1, 5, 6, 4, 33), 1, 2, "VALID", 3),
    "c2_k7s2_same": (2, (2, 11, 9, 3), 7, 2, "SAME", 8),
    "c2_k3s1_same": (2, (2, 9, 8, 5), 3, 1, "SAME", 7),
    "c2_k3s2_valid": (2, (1, 10, 9, 16), 3, 2, "VALID", 4),
    "c2_k2s2_same": (2, (1, 7, 8, 6), 2, 2, "SAME", 5),
    "c2_k1s1_valid": (2, (2, 5, 6, 40), 1, 1, "VALID", 17),
}
# name: (net, features, classes, x shape, packed_levels or None)
NET_CASES = {
    "vnet8": ("vnet", 8, 2, (1, 16, 16, 16, 1), None),
    "vnet16_l1": ("vnet", 16, 2, (1, 32, 32, 32, 1), 1),
    "vnet16_l2": ("vnet", 16, 2, (1, 32, 32, 32, 1), 2),
    "unet16": ("unet", 16, 3, (1, 16, 16, 16, 1), 1),
}
SHIFT_AXES = [(True, True, True), (False, True, True), (True, False, True)]
LOSSES = ["cross_entropy_loss", "focal_loss", "dice_loss", "ce_dice_loss",
          "el_dice_loss", "ss_loss", "tversky_loss"]
LOSS_K = 5
ALPHA = [1.0, 2.0, 0.5, 1.5, 1.0]
STEP = (16, 5, (1, 16, 16, 16, 1))  # UNet3d features, classes, image shape


def x_of(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def w_of(seed: int, shape, scale: float = 0.3) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def conv_inputs(name: str):
    """(x, kernel (*k, Cin, Cout), bias) of a conv case."""
    ndim, shape, k, _, _, cout = CONV_CASES[name]
    seed = sorted(CONV_CASES).index(name)
    return (x_of(100 + seed, shape), w_of(200 + seed, (k,) * ndim + (shape[-1], cout)),
            w_of(300 + seed, (cout,)))


def net_tree(case: str) -> dict:
    from tpuseg_torch.compat.weights import seeded_unet_params, seeded_vnet_params

    net, f, k, _, _ = NET_CASES[case]
    return (seeded_vnet_params if net == "vnet" else seeded_unet_params)(0, f, k, 1)


def net_input(case: str) -> np.ndarray:
    return x_of(7, NET_CASES[case][3])


def fast_vnet_tree() -> dict:
    """The seeded VNet tree (features 8, 2 classes) under the GEMM fast
    path's names: each DownTransition's k2 s2 conv holds ``kernel_s2d`` /
    ``bias_s2d``, each UpTransition's transpose conv ``kernel_d2s`` /
    ``bias_d2s`` (JAX's init under ``USE_GEMM_FASTPATH`` on even sides;
    the generator checks the structure against it)."""
    from tpuseg_torch.compat.weights import seeded_vnet_params

    tree = seeded_vnet_params(0, 8, 2, 1)
    for name, node in tree.items():
        if name.startswith("DownTransition_"):
            conv = node["ConvND_0"].pop("Conv_0")
            node["ConvND_0"].update(kernel_s2d=conv["kernel"], bias_s2d=conv["bias"])
        if name.startswith("UpTransition_"):
            conv = node["ConvTransposeND_0"].pop("ConvTranspose_0")
            node["ConvTransposeND_0"].update(kernel_d2s=conv["kernel"], bias_d2s=conv["bias"])
    return tree


def checksum(wq) -> np.int64:
    """An int8 weight's order-sensitive checksum."""
    w = np.asarray(wq, np.int64).reshape(-1)
    return np.int64(np.sum(w * (np.arange(w.size) % 251 + 1)))


def loss_data():
    """(class-major packed logits (2, 8, 8, 8, 40), labels (2, 16, 16, 16))."""
    rng = np.random.default_rng(0)
    logitsp = rng.normal(size=(2, 8, 8, 8, 8 * LOSS_K)).astype(np.float32)
    labels = rng.integers(0, LOSS_K, size=(2, 16, 16, 16)).astype(np.int32)
    return logitsp, labels


def step_inputs():
    rng = np.random.default_rng(11)
    _, k, shape = STEP
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, k, shape[:-1]).astype(np.int32))


# --------------------------------------------------------------- JAX side


@contextlib.contextmanager
def _int8_sites(sites: list):
    """Record every int8 ``lax.conv_general_dilated`` (JAX's int8 routes
    call it through ``jax.lax``)."""
    import jax

    orig = jax.lax.conv_general_dilated

    def rec(lhs, rhs, window_strides, padding, *a, **kw):
        out = orig(lhs, rhs, window_strides, padding, *a, **kw)
        if lhs.dtype == np.int8:
            pads = (jax.lax.padtype_to_pads(lhs.shape[1:-1], rhs.shape[:-2], window_strides,
                                            padding) if isinstance(padding, str) else padding)
            sites.append({"x": np.asarray(lhs), "w": np.asarray(rhs), "acc": np.asarray(out),
                          "strides": tuple(window_strides),
                          "pads": tuple(tuple(int(v) for v in p) for p in pads)})
        return out

    jax.lax.conv_general_dilated = rec
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = orig


def site_table(sites) -> np.ndarray:
    """One int64 row per site: ndim, x shape (5, 2D padded with 1), w shape
    (5), strides (3), pads (6), weight checksum."""
    rows = []
    for s in sites:
        xs, ws = list(s["x"].shape), list(s["w"].shape)
        st, pads = list(s["strides"]), [list(p) for p in s["pads"]]
        nd = len(st)
        if nd == 2:
            xs, ws, st, pads = xs[:1] + [1] + xs[1:], [1] + ws, [1] + st, [[0, 0]] + pads
        rows.append([nd] + xs + ws + st + sum(pads, []) + [int(checksum(s["w"]))])
    return np.asarray(rows, np.int64)


def _conv_cases(out: dict) -> None:
    import jax.numpy as jnp

    from tpuseg.nn import layers

    for name, (ndim, shape, k, s, pad, cout) in CONV_CASES.items():
        x, w, b = conv_inputs(name)
        conv = layers.ConvND(cout, ndim, k, strides=s, padding=pad)
        params = {"params": {"Conv_0": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}}
        sites = []
        with layers.int8_inference(), _int8_sites(sites):
            y = conv.apply(params, jnp.asarray(x))
        (site,) = sites
        out.update({f"conv/{name}/y": np.asarray(y), f"conv/{name}/xq": site["x"],
                    f"conv/{name}/wq": site["w"], f"conv/{name}/acc": site["acc"],
                    f"conv/{name}/pads": np.asarray(site["pads"], np.int64)})


def _net_apply(case: str, params, x):
    import jax.numpy as jnp

    from tpuseg.models.unet_packed import packed_unet3d_apply
    from tpuseg.models.vnet import VNet
    from tpuseg.models.vnet_packed import packed_vnet3d_apply

    net, f, k, _, lv = NET_CASES[case]
    if lv is None:
        return VNet(ndim=3, num_classes=k, features=f, dropout=0.0).apply(params, x)
    twin = packed_vnet3d_apply if net == "vnet" else packed_unet3d_apply
    return twin(params, jnp.asarray(x), num_classes=k, features=f, packed_levels=lv)


def _net_cases(out: dict) -> None:
    import jax.numpy as jnp

    from tpuseg.models import vnet_packed
    from tpuseg.nn import layers

    for case in NET_CASES:
        params = {"params": net_tree(case)}
        x = jnp.asarray(net_input(case))
        logits_f, _ = _net_apply(case, params, x)
        flag = layers.int8_inference if NET_CASES[case][4] is None \
            else vnet_packed.int8_packed_inference
        sites = []
        with flag(), _int8_sites(sites):
            logits, _ = _net_apply(case, params, x)
        out.update({f"net/{case}/mask": np.asarray(logits).argmax(-1).astype(np.uint8),
                    f"net/{case}/logits_f32": PT.fingerprint(logits_f),
                    f"net/{case}/sites": site_table(sites)})
        print(f"  net/{case}: {len(sites)} int8 sites", flush=True)


def _fast_cases(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.vnet import VNet
    from tpuseg.nn import layers

    for ndim, shape in ((2, (2, 8, 8, 3)), (3, (1, 8, 8, 8, 3))):
        x = jnp.asarray(x_of(20 + ndim, shape))
        layer = layers.ConvND(7, ndim, 2, strides=2, padding="VALID", use_gemm_fastpath=True)
        p = layer.init(jax.random.key(0), x)
        p = {"params": {"kernel_s2d": p["params"]["kernel_s2d"],
                        "bias_s2d": jnp.asarray(w_of(30 + ndim, (7,)))}}
        out.update({f"fast/s2d{ndim}/kernel": np.asarray(p["params"]["kernel_s2d"]),
                    f"fast/s2d{ndim}/bias": np.asarray(p["params"]["bias_s2d"]),
                    f"fast/s2d{ndim}/y": np.asarray(layer.apply(p, x))})
    for ndim, shape in ((2, (2, 8, 8, 3)), (3, (1, 4, 4, 4, 3))):
        x = jnp.asarray(x_of(40 + ndim, shape))
        layer = layers.ConvTransposeND(6, ndim, 2, 2, use_gemm_fastpath=True)
        p = layer.init(jax.random.key(0), x)
        p = {"params": {"kernel_d2s": p["params"]["kernel_d2s"],
                        "bias_d2s": jnp.asarray(w_of(50 + ndim, (6,)))}}
        out.update({f"fast/d2s{ndim}/kernel": np.asarray(p["params"]["kernel_d2s"]),
                    f"fast/d2s{ndim}/bias": np.asarray(p["params"]["bias_d2s"]),
                    f"fast/d2s{ndim}/y": np.asarray(layer.apply(p, x))})
    x = jnp.asarray(x_of(60, (1, 7, 7, 3)))
    layer = layers.ConvND(4, 2, 2, strides=2, padding="VALID", use_gemm_fastpath=True)
    p = layer.init(jax.random.key(0), x)
    out.update({f"fast/odd/{n}": np.asarray(v) for n, v in p["params"]["Conv_0"].items()})
    out["fast/odd/y"] = np.asarray(layer.apply(p, x))
    # a VNet run under the flag: its tree holds kernel_s2d / kernel_d2s
    prev = layers.USE_GEMM_FASTPATH
    layers.USE_GEMM_FASTPATH = True
    try:
        model = VNet(ndim=3, num_classes=2, features=8, dropout=0.0)
        x = jnp.asarray(x_of(61, (1, 16, 16, 16, 1)))
        tree = fast_vnet_tree()
        want = jax.eval_shape(model.init, jax.random.key(0), x)["params"]
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
        assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), want), \
            "fast_vnet_tree is not the tree JAX makes under USE_GEMM_FASTPATH"
        logits, _ = model.apply({"params": tree}, x)
    finally:
        layers.USE_GEMM_FASTPATH = prev
    out["fast/vnet/logits"] = PT.fingerprint(logits)


def _shift_cases(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from tpuseg.models import vnet_packed
    from tpuseg.models.unet_packed import _concat_perm

    prev = vnet_packed.USE_SHIFT_PACKED_K3
    vnet_packed.USE_SHIFT_PACKED_K3 = True
    try:
        for i, axes in enumerate(SHIFT_AXES):
            p = 2 ** sum(axes)
            x = jnp.asarray(x_of(70 + i, (2, 5, 4, 6, p * 3)))
            w = jnp.asarray(w_of(80 + i, (3, 3, 3, 3, 3)))
            out[f"shift/k3_{i}"] = np.asarray(vnet_packed.packed_k3_conv((x,), w, axes))
        up, sk = jnp.asarray(x_of(90, (1, 4, 4, 4, 16))), jnp.asarray(x_of(91, (1, 4, 4, 4, 16)))
        w = jnp.asarray(w_of(92, (3, 3, 3, 4, 2)))
        out["shift/concat"] = np.asarray(vnet_packed.packed_k3_conv(
            (up, sk), w, (True, True, True), in_perm=jnp.asarray(_concat_perm(2))))
        x = jnp.asarray(x_of(93, (1, 4, 4, 4, 16)))
        w = jnp.asarray(w_of(94, (3, 3, 3, 2, 2)))
        out["shift/grad_w"] = np.asarray(jax.grad(lambda wf: jnp.sum(
            vnet_packed.packed_k3_conv((x,), wf, (True, True, True)) ** 2))(w))
        for case in ("vnet16_l1", "vnet16_l2", "unet16"):
            logits, _ = _net_apply(case, {"params": net_tree(case)}, net_input(case))
            out[f"shift/{case}/logits"] = PT.fingerprint(logits)
        for case in ("vnet64_l1", "vnet64_l2", "unet64_l1"):
            jax.config.update("jax_enable_x64", True)
            try:
                got = PT._x64_case(case)
            finally:
                jax.config.update("jax_enable_x64", False)
            out.update({f"shift/{k}": v for k, v in got.items()})
            print(f"  shift/{case}", flush=True)
    finally:
        vnet_packed.USE_SHIFT_PACKED_K3 = prev


def _k4s2_cases(out: dict) -> None:
    from tpuseg.models import vnet_packed

    prev = vnet_packed.LUCONV96_MODE
    vnet_packed.LUCONV96_MODE = "k4s2"
    try:
        for case in ("vnet16_l1", "vnet16_l2"):
            logits, _ = _net_apply(case, {"params": net_tree(case)}, net_input(case))
            out[f"k4s2/{case}/logits"] = PT.fingerprint(logits)
    finally:
        vnet_packed.LUCONV96_MODE = prev


def _loss_cases(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from tpuseg.losses import packed_class
    from tpuseg.models.unet_packed import space_to_depth_labels
    from tpuseg.models.vnet_packed import packed_softmax

    logitsp, labels = loss_data()
    lp = jnp.asarray(logitsp)
    lb8 = space_to_depth_labels(jnp.asarray(labels))
    lb8_missing = space_to_depth_labels(jnp.asarray(np.where(labels == 3, 0, labels)))
    for name in LOSSES:
        fn = getattr(packed_class, name)
        value, grad = jax.value_and_grad(
            lambda a: fn(a, lb8, alpha=ALPHA, num_classes=LOSS_K))(lp)
        out[f"loss/{name}/value"] = np.float64(value)
        out[f"loss/{name}/grad"] = PT.fingerprint(grad)
        out[f"loss/{name}/missing"] = np.float64(fn(lp, lb8_missing, num_classes=LOSS_K))
    probs = packed_softmax(lp, LOSS_K, layout="class")
    for name in ("multiclass_dice_coeff", "multiclass_iou_coeff"):
        out[f"loss/{name}"] = np.float64(getattr(packed_class, name)(
            probs, lb8, num_classes=LOSS_K))


def _step_cases(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet import UNet
    from tpuseg.tasks import segmentation

    f, k, shape = STEP
    image, label = (jnp.asarray(a) for a in step_inputs())
    params = {"params": PT.seeded_params("unet")}
    batch = {"image": image, "label": label}
    for case, flag in (("class", "USE_PACKED_CLASS_LOSS"), ("grid", "USE_PACKED_GRID_LOSS")):
        prev = getattr(segmentation, flag)
        setattr(segmentation, flag, True)
        try:
            model = UNet(ndim=3, num_classes=k, features=f, dropout=0.0)
            trainer = segmentation.make_segmentation_trainer(
                model, image, k, "MutilDiceLoss", alpha=[1.0] * k, packed_stem=True)

            def loss_of(p):
                outputs = trainer.apply_fn(p, batch, True, None)
                return trainer.loss_fn(outputs, batch), outputs

            (value, outputs), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
            metric = trainer.metric_fn(outputs, batch)
        finally:
            setattr(segmentation, flag, prev)
        out[f"step/{case}/loss"] = np.float64(value)
        out[f"step/{case}/metric"] = np.float64(metric)
        out[f"step/{case}/packed_shape"] = np.asarray(outputs["logits"].shape, np.int64)
        out.update({f"step/{case}/grad/{n}": PT.fingerprint(g)
                    for n, g in PT.port_grads("unet", grads["params"], np.float32).items()})
        print(f"  step/{case}", flush=True)


def compute_golden() -> dict:
    out = {}
    for part in (_conv_cases, _net_cases, _fast_cases, _shift_cases, _k4s2_cases,
                 _loss_cases, _step_cases):
        part(out)
        print(f"  {part.__name__}", flush=True)
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
