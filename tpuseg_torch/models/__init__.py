"""Model zoo of tpuseg_torch, and its registry (``build_model``), keyed by
the names of ``tpuseg/models/__init__.py``'s."""
from __future__ import annotations

# the registry's names of the ported nets, and the JAX registry's other names
PORTED = ("unet2d", "unet3d", "unet", "unet3dthin", "unetthin", "vnet2d", "vnet3d",
          "vnet", "resnet2d", "resnet3d", "resnet", "resunet3d", "stunet3d", "kiunet3d",
          "kiunet3dthin", "tpddnet", "vnet3dregistration", "unext2d", "unext2ds",
          "amlpunet2d", "smt", "vsnet")
NOT_PORTED = ()


def build_model(name: str, num_classes: int, ndim: int = 3, **kw):
    """The port's net called ``name`` (case-insensitive), as the JAX
    ``build_model`` names it: unet2d / unet3d / unet, unet3dthin / unetthin,
    vnet2d / vnet3d / vnet, resnet2d / resnet3d / resnet (the classifier),
    resunet3d, stunet3d, kiunet3d / kiunet3dthin, tpddnet,
    vnet3dregistration (which, as in JAX, ignores ``num_classes``), the
    2D MLP nets unext2d, unext2ds and amlpunet2d, and the attention nets
    smt (``SMTSeg3d``, smt_t's widths unless ``kw`` say otherwise) and
    vsnet (``VSNet``, which, as in JAX, ignores ``num_classes``).  A name
    without its rank takes ``ndim``.  ``kw`` go to the module
    (``features``, ``dropout``, ``in_channels``, ``generator``; TPDDNet and
    the UNeXt nets take only the last two, AmlpUNet2d also ``features``;
    SMTSeg3d and VSNet their own fields, ``in_channels`` and
    ``generator``).  Every other name raises NotImplementedError naming
    the ported ones."""
    from tpuseg_torch.models.kiunet3d import KiUNet3d
    from tpuseg_torch.models.registration import VNet3dRegistration
    from tpuseg_torch.models.resnet import ResNetClassifier
    from tpuseg_torch.models.resunet3d import ResUNet3d
    from tpuseg_torch.models.stunet3d import STUNet3d
    from tpuseg_torch.models.tpddnet import TPDDNet
    from tpuseg_torch.models.unet import UNet, UNetThin
    from tpuseg_torch.models.vnet import VNet

    name = name.lower()
    if name in ("unet2d", "unet3d", "unet", "vnet2d", "vnet3d", "vnet", "resnet2d",
                "resnet3d", "resnet"):
        nd = 2 if name.endswith("2d") else (3 if name.endswith("3d") else ndim)
        if name.startswith("resnet"):
            return ResNetClassifier(num_classes, ndim=nd, **kw)
        return (UNet if name.startswith("unet") else VNet)(num_classes, ndim=nd, **kw)
    if name == "vnet3dregistration":
        return VNet3dRegistration(**kw)
    if name in ("unext2d", "unext2ds"):
        from tpuseg_torch.models.unext2d import UNeXt2d, UNeXt2dS

        return (UNeXt2dS if name == "unext2ds" else UNeXt2d)(num_classes, **kw)
    if name == "amlpunet2d":
        from tpuseg_torch.models.amlp_unet2d import AmlpUNet2d

        return AmlpUNet2d(num_classes, **kw)
    if name == "smt":
        from tpuseg_torch.models.smt import SMTSeg3d

        return SMTSeg3d(num_classes, **kw)
    if name == "vsnet":
        from tpuseg_torch.models.vsnet import VSNet

        return VSNet(**kw)
    cls = {"unet3dthin": UNetThin, "unetthin": UNetThin,
           "resunet3d": ResUNet3d, "stunet3d": STUNet3d,
           "kiunet3d": KiUNet3d, "kiunet3dthin": KiUNet3d, "tpddnet": TPDDNet}.get(name)
    if cls is not None:
        return cls(num_classes, **kw)
    what = "is not ported yet" if name in NOT_PORTED else "is not a model of the zoo"
    raise NotImplementedError(f"model {name!r} {what} (ported: {', '.join(PORTED)})")
