"""Write tests/data/torch_port_entry_golden.npz: the masks that
``examples/inference.py``'s ``main`` writes for a folder of two NIfTI
volumes, for ``tests/test_torch_port_entry.py``, which holds
``python -m tpuseg_torch.inference`` to them without JAX (the JAX class's
compiles take ~80 s on one core with a cold cache).

    JAX_PLATFORMS=cpu python tests/make_torch_port_entry_golden.py

About a minute on one core.  Rerun it when ``tpuseg/`` changes what it
computes.  The inputs (``write_inputs``: two int16 volumes and a file the
scripts skip) and the weights (``write_weights``: UNet3d features 8, 3
classes, ``seeded_unet_params(5, ...)`` as a reference-named ``.pth``)
are remade by the test from the same functions; ``FLAGS`` are the
scripts' flags.  Stored: ``names`` (the written files, sorted) and, per
file, ``<name>/mask`` and ``<name>/spacing``.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_entry_golden.npz")
CASES = (("case1.nii.gz", (20, 24, 28)), ("case0.nii", (18, 20, 22)))


def FLAGS(weights: str):
    return ["--infer.model_dir", weights, "--model.num_classes", "3",
            "--model.features", "8", "--infer.new_size", "[16,16,16]"]


def write_inputs(root: str) -> str:
    """The input folder: the two volumes of ``CASES`` and a text file."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.data.geometry import Volume
    from tpuseg_torch.data.nifti import write_nifti

    src = os.path.join(root, "in")
    os.makedirs(src)
    rng = np.random.default_rng(8)
    for name, shape in CASES:
        vol = Volume(rng.normal(0, 300, shape).astype(np.int16))
        vol.spacing, vol.origin = (0.8, 0.9, 1.6), (-5.0, 2.0, 1.0)
        write_nifti(vol, os.path.join(src, name))
    with open(os.path.join(src, "readme.txt"), "w") as f:
        f.write("not a volume")
    return src


def write_weights(path: str) -> str:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
    from tpuseg_torch.models.unet import UNet

    net = UNet(3, features=8)
    net.load_state_dict(unet_params_from_jax(seeded_unet_params(5, 8, 3, 1)), strict=True)
    torch.save(net.state_dict(), path)
    return path


def load() -> dict:
    g = np.load(GOLDEN)
    return {k: g[k] for k in g.files}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpuseg_torch.data.nifti import read_nifti

    spec = importlib.util.spec_from_file_location(
        "jax_example_inference", os.path.join(REPO, "examples", "inference.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory() as tmp:
        src = write_inputs(tmp)
        flags = FLAGS(write_weights(os.path.join(tmp, "w.pth")))
        # the script takes a flag's value after a space for a path: "=" only
        example.main([f"{k}={v}" for k, v in zip(flags[::2], flags[1::2])]
                     + [src, os.path.join(tmp, "out")])
        names = sorted(os.listdir(os.path.join(tmp, "out")))
        data = {"names": np.array(names)}
        for n in names:
            vol = read_nifti(os.path.join(tmp, "out", n))
            data[f"{n}/mask"] = vol.array
            data[f"{n}/spacing"] = np.asarray(vol.spacing, np.float64)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **data)
    print(f"wrote {GOLDEN}: {len(data)} arrays, {os.path.getsize(GOLDEN)} bytes")
