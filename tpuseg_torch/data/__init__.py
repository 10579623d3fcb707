"""Host data layer of tpuseg_torch: datasets and the loader, 3D
augmentation, geometry, normalizers, NIfTI IO."""
