"""Reference-compatible Model API and weight conversion of tpuseg_torch:
the thirteen Model classes of ``tpuseg/compat/__init__.py``."""
from tpuseg_torch.compat.gan_model import Pixel2PixelGAN2dModel  # noqa: F401
from tpuseg_torch.compat.resnet_models import (  # noqa: F401
    BinaryResNet2dModel,
    BinaryResNet3dModel,
    MutilResNet2dModel,
    MutilResNet3dModel,
)
from tpuseg_torch.compat.seg_models import (  # noqa: F401
    BinaryUNet2dModel,
    BinaryUNet3dModel,
    BinaryVNet2dModel,
    BinaryVNet3dModel,
    MutilUNet2dModel,
    MutilUNet3dModel,
    MutilVNet2dModel,
    MutilVNet3dModel,
)

__all__ = ["BinaryUNet2dModel", "BinaryUNet3dModel", "MutilUNet2dModel",
           "MutilUNet3dModel", "BinaryVNet2dModel", "BinaryVNet3dModel",
           "MutilVNet2dModel", "MutilVNet3dModel", "BinaryResNet2dModel",
           "BinaryResNet3dModel", "MutilResNet2dModel", "MutilResNet3dModel",
           "Pixel2PixelGAN2dModel"]
