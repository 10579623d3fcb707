"""Where a Model class's weights come from: ``load_weights`` turns what a
user passes as ``model_path`` into the port's state_dict, and
``load_gan_weights`` into the pix2pix generator's and, where the source
holds it, the discriminator's.  The sources, in the order they are tried:

* a state_dict (a mapping of tensors or arrays) passes as it is;
* a ``.pth`` / ``.pt`` file: a reference-named state_dict (``torch.save``
  of the reference framework or of the port);
* a tpuseg run: a ``state.msgpack`` file, a checkpoint directory holding
  one (or its ``.old`` copy), or a run directory holding ``best/``: its
  parameter tree converted by ``compat/weights.py`` for ``net``;
* a run of the port's own trainer: ``state.pt`` in the directory or in
  ``best/``, its model's state_dict;
* a directory holding exactly one ``.pth`` / ``.pt`` file.

A GAN run, tpuseg's or the port's, keeps both nets' checkpoints under
``G/``; ``load_gan_weights`` looks there first.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import torch

from tpuseg_torch.compat.weights import params_from_jax
from tpuseg_torch.core.checkpoint import is_tpuseg_run, read_run


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _source(path: str) -> Tuple[str, str]:
    """("torch", a .pth / .pt file), ("port", a port run's state.pt) or
    ("tpuseg", a tpuseg run) for ``path`` (see the module's list)."""
    if os.path.isfile(path) and path.endswith((".pth", ".pt")):
        return "torch", path
    if is_tpuseg_run(path):
        return "tpuseg", path
    if os.path.isdir(path):
        for d in (path, os.path.join(path, "best")):
            if os.path.isfile(os.path.join(d, "state.pt")):
                return "port", os.path.join(d, "state.pt")
        found = sorted(f for f in os.listdir(path) if f.endswith((".pth", ".pt")))
        if len(found) == 1:
            return "torch", os.path.join(path, found[0])
        if len(found) > 1:
            raise ValueError(f"{path}: several checkpoints {found}; name the .pth file")
    raise FileNotFoundError(
        f"{path}: no .pth/.pt checkpoint, tpuseg state.msgpack or tpuseg_torch "
        "state.pt")


def load_weights(path_or_sd, net: str, levels: int = 4) -> Mapping:
    """The port's state_dict for ``net`` (a ``compat/weights.py``
    ``params_from_jax`` name) from ``path_or_sd`` (see the module's list)."""
    if isinstance(path_or_sd, Mapping):
        return path_or_sd
    kind, src = _source(os.fspath(path_or_sd))
    if kind == "tpuseg":
        return params_from_jax(net, read_run(src)["params"], levels=levels)
    state = _torch_load(src)
    return state["model"] if kind == "port" else state


def load_gan_weights(path_or_sd) -> Tuple[Mapping, Optional[Mapping]]:
    """(generator, discriminator) state_dicts of the pix2pix nets: both from
    a GAN run (tpuseg's ``g_params`` / ``d_params``, the port's
    ``generator`` / ``discriminator``); the generator alone, with None, from
    a state_dict or a reference ``.pth``."""
    if isinstance(path_or_sd, Mapping):
        return path_or_sd, None
    path = os.fspath(path_or_sd)
    if os.path.isdir(os.path.join(path, "G")):
        path = os.path.join(path, "G")
    kind, src = _source(path)
    if kind == "tpuseg":
        state = read_run(src)
        if "g_params" not in state:
            raise ValueError(f"{src}: a tpuseg run without g_params / d_params is not a "
                             "GAN run")
        return (params_from_jax("pix2pix_generator", state["g_params"]),
                params_from_jax("pix2pix_discriminator", state["d_params"]))
    state = _torch_load(src)
    if kind == "port":
        return state["generator"], state["discriminator"]
    return state, None
