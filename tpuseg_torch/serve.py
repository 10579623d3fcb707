"""HTTP serving entry point of the port: load one MutilUNet3dModel at
startup on the GPU and serve POST /predict and GET /getresult on
0.0.0.0:8000 (the flags of ``examples/serve.py``).

    python -m tpuseg_torch.serve --infer.model_dir runs/unet3d/model.pth \
        --model.num_classes 5 --infer.new_size "[112,112,128]" --model.features 16

    curl -F "file=@case.nii.gz" http://localhost:8000/predict
    curl -o mask.nii.gz "http://localhost:8000/getresult?file=case_mask.nii.gz"

``--infer.model_dir`` names a reference-named ``.pth`` file, a directory
holding exactly one, or a tpuseg run (its directory with ``best/``, a
checkpoint directory, or ``state.msgpack`` itself: the UNet parameter tree
converted).  Without it the weights are random (seeded).
"""
from __future__ import annotations

from tpuseg_torch.compat.seg_models import MutilUNet3dModel
from tpuseg_torch.config import Config, parse_cli
from tpuseg_torch.infer.serving import SegServer


def build_model(cfg: Config, device="cuda") -> MutilUNet3dModel:
    x, y, z = cfg.infer.new_size
    return MutilUNet3dModel(
        z, y, x, cfg.model.image_channel, cfg.model.num_classes,
        batch_size=1, inference=bool(cfg.infer.model_dir),
        model_path=cfg.infer.model_dir or None, features=cfg.model.features,
        device=device,
    )


def main(argv=None):
    cfg = parse_cli(argv)
    SegServer(build_model(cfg), new_size=cfg.infer.new_size).run("0.0.0.0", 8000)


if __name__ == "__main__":
    main()
