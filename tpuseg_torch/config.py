"""Config + CLI for the port's entry points (counterpart of
``tpuseg/config.py``).

Overrides take the JAX package's form, ``--section.field value`` or
``--section.field=value``; tuples, lists and fields that default to None
are given as JSON.  Fields the port cannot honour yet (the mesh and
profiler traces) raise when set to anything but their default.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field, fields
from typing import List, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    name: str = "unet3d"  # a name of models.build_model: unet3d, vnet3d, resunet3d, ...
    num_classes: int = 2
    image_channel: int = 1
    features: int = 16
    dropout: float = 0.2


@dataclass
class DataConfig:
    train_csv: str = ""
    train_aug_csv: str = ""  # optional augmented manifest, appended to train
    val_csv: str = ""
    image_size: Tuple[int, ...] = (112, 112, 128)  # (x, y, z)
    batch_size: int = 1
    binary_labels: bool = False  # labels != 0 -> 1
    online_augment: bool = False  # a fresh random affine per sample (data/augment3d.py)
    shuffle_seed: int = 0


@dataclass
class TrainConfig:
    epochs: int = 100
    lr: float = 1e-3
    optimizer: str = "adam"
    loss_name: str = "MutilDiceLoss"
    alpha: Optional[List[float]] = None
    gamma: float = 2.0
    accuracy_name: str = "dice"
    grad_clip: Optional[float] = None
    early_stop_patience: Optional[int] = None
    model_dir: str = "log/run"
    resume: bool = False
    mesh_data: int = -1  # not ported yet
    mesh_model: int = 1  # not ported yet
    mesh_space: int = 1  # not ported yet
    packed_stem: bool = False  # train through the space-to-depth packed twin
    profile: bool = False  # not ported yet
    compute_dtype: str = "float32"  # "bfloat16": f32 master weights, bf16 compute


@dataclass
class InferConfig:
    model_dir: str = ""
    new_size: Tuple[int, int, int] = (112, 112, 128)  # (x, y, z)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    def to_json(self) -> str:
        return json.dumps({f.name: vars(getattr(self, f.name)) for f in fields(self)},
                          indent=2)


# settings whose paths are not ported yet: they must keep these defaults
NOT_PORTED = {
    ("train", "mesh_data"): -1, ("train", "mesh_model"): 1,
    ("train", "mesh_space"): 1, ("train", "profile"): False,
}


def _parse(current, value: str):
    if isinstance(current, bool):
        if value.lower() not in ("1", "true", "yes", "0", "false", "no"):
            raise ValueError(f"not a boolean: {value!r}")
        return value.lower() in ("1", "true", "yes")
    if current is None or isinstance(current, list):
        return json.loads(value)
    if isinstance(current, tuple):
        parsed = tuple(json.loads(value))
        if len(parsed) != len(current):
            raise ValueError(f"needs {len(current)} values: {value}")
        return parsed
    return type(current)(value)


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse ``--section.field value`` overrides onto the defaults."""
    args = list(sys.argv[1:] if argv is None else argv)
    cfg = Config()
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--") or "." not in arg:
            raise ValueError(f"bad override {arg!r}: expected --section.field value")
        path = arg[2:]
        if "=" in path:
            path, value = path.split("=", 1)
            i += 1
        elif i + 1 < len(args):
            value = args[i + 1]
            i += 2
        else:
            raise ValueError(f"override {arg!r} has no value")
        section_name, field_name = path.split(".", 1)
        section = getattr(cfg, section_name, None)
        if section is None or not hasattr(section, field_name):
            raise ValueError(f"unknown setting {path!r}")
        try:
            parsed = _parse(getattr(section, field_name), value)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        if NOT_PORTED.get((section_name, field_name), parsed) != parsed:
            raise ValueError(f"--{path} {value}: not ported yet (only the default "
                             f"{NOT_PORTED[(section_name, field_name)]!r} runs)")
        setattr(section, field_name, parsed)
    return cfg
