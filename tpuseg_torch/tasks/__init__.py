"""Tasks: the generic Trainer, the segmentation and the registration task."""
