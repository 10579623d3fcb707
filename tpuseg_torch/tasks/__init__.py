"""Tasks: the generic Trainer and the segmentation task."""
