"""Batch folder inference of the port (counterpart of
``examples/inference.py``): every ``.nii`` / ``.nii.gz`` of a directory
through ``MutilUNet3dModel.inference`` at a fixed size, the masks written
beside each other as ``<name>_mask.nii[.gz]``.

    python -m tpuseg_torch.inference --infer.model_dir log/run \\
        --model.num_classes 5 --infer.new_size "[112,112,128]" <input_dir> <output_dir>

The weights come from ``--infer.model_dir``: a reference-named ``.pth``,
a tpuseg run (``state.msgpack``) or a run of the port's trainer
(``compat/checkpoints.py``).  As in the JAX script the net is UNet3d with
``--model.features`` and ``--model.image_channel``; where every side of
``--infer.new_size`` divides by 16 the packed twin serves it, as
``MutilUNet3dModel.inference`` does.  It runs on the card.
"""
from __future__ import annotations

import sys

from tpuseg_torch.config import parse_cli


def split_argv(argv):
    """(flags, positional arguments): ``--section.field=value`` is one
    flag, ``--section.field value`` two words of one (the JAX script takes
    the value of the second form for a path)."""
    flags, paths = [], []
    i = 0
    while i < len(argv):
        if argv[i].startswith("--"):
            n = 1 if "=" in argv[i] else 2
            flags += argv[i:i + n]
            i += n
        else:
            paths.append(argv[i])
            i += 1
    return flags, paths


def main(argv=None, device="cuda") -> list:
    """Returns the output paths, in the input files' sorted order."""
    flags, paths = split_argv(list(sys.argv[1:] if argv is None else argv))
    if len(paths) != 2:
        raise SystemExit("usage: python -m tpuseg_torch.inference [flags] "
                         "<input_dir> <output_dir>")
    in_dir, out_dir = paths
    cfg = parse_cli(flags)

    from tpuseg_torch.compat.seg_models import MutilUNet3dModel
    from tpuseg_torch.recipes import _folder_inference_3d

    x, y, z = cfg.infer.new_size
    model = MutilUNet3dModel(
        z, y, x, cfg.model.image_channel, cfg.model.num_classes, batch_size=1,
        loss_name=cfg.train.loss_name, inference=True, model_path=cfg.infer.model_dir,
        features=cfg.model.features, device=device)
    return _folder_inference_3d(model, in_dir, out_dir, tuple(cfg.infer.new_size),
                                print_labels=True)

if __name__ == "__main__":
    main()
