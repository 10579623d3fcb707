"""Model zoo of tpuseg_torch, and its registry (``build_model``), keyed by
the names of ``tpuseg/models/__init__.py``'s."""
from __future__ import annotations

# the registry's names of the ported nets, and the JAX registry's other names
PORTED = ("unet3d", "unet", "unet3dthin", "unetthin", "vnet3d", "vnet", "resunet3d",
          "stunet3d", "kiunet3d", "kiunet3dthin", "tpddnet", "vnet3dregistration")
NOT_PORTED = ("unet2d", "vnet2d", "resnet2d", "resnet3d", "resnet", "unext2d",
              "unext2ds", "amlpunet2d", "smt", "vsnet")


def build_model(name: str, num_classes: int, ndim: int = 3, **kw):
    """The port's net called ``name`` (case-insensitive), as the JAX
    ``build_model`` names it: unet3d / unet, unet3dthin / unetthin, vnet3d /
    vnet, resunet3d, stunet3d, kiunet3d / kiunet3dthin, tpddnet and
    vnet3dregistration (which, as in JAX, ignores ``num_classes``).  ``kw``
    go to the module (``features``, ``dropout``, ``in_channels``,
    ``generator``; TPDDNet takes only the last two).  ``ndim`` 2 and every
    other name raise NotImplementedError naming the ported ones."""
    from tpuseg_torch.models.kiunet3d import KiUNet3d
    from tpuseg_torch.models.registration import VNet3dRegistration
    from tpuseg_torch.models.resunet3d import ResUNet3d
    from tpuseg_torch.models.stunet3d import STUNet3d
    from tpuseg_torch.models.tpddnet import TPDDNet
    from tpuseg_torch.models.unet import UNet, UNetThin
    from tpuseg_torch.models.vnet import VNet

    name = name.lower()
    if ndim != 3 and name in ("unet", "vnet"):
        name += "2d"
    if name == "vnet3dregistration":
        return VNet3dRegistration(**kw)
    cls = {"unet3d": UNet, "unet": UNet, "unet3dthin": UNetThin, "unetthin": UNetThin,
           "vnet3d": VNet, "vnet": VNet, "resunet3d": ResUNet3d, "stunet3d": STUNet3d,
           "kiunet3d": KiUNet3d, "kiunet3dthin": KiUNet3d, "tpddnet": TPDDNet}.get(name)
    if cls is not None:
        return cls(num_classes, **kw)
    what = "is not ported yet" if name in NOT_PORTED else "is not a model of the zoo"
    raise NotImplementedError(f"model {name!r} {what} (ported: {', '.join(PORTED)})")
