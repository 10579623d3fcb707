"""Training curves (counterpart of ``tpuseg/tools/visualization.py``
``plot_result``).

matplotlib is used when it imports; otherwise the curves are written as
JSON, with a warning (shown once per process by Python's default warning
filter).  The mask bitmaps
(``make_seg_viz``, cv2) are not ported yet.
"""
from __future__ import annotations

import json
import os
import warnings


def plot_result(model_dir: str, v1, v2, name1: str, name2: str, title: str) -> str:
    """Paired train/val curve: ``<model_dir>/<title>.png``, or
    ``<title>.json`` without matplotlib.  Returns the path written."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("matplotlib is not installed: training curves are "
                      "written as JSON", stacklevel=2)
        path = os.path.join(model_dir, title + ".json")
        with open(path, "w") as f:
            json.dump({name1: [float(v) for v in v1], name2: [float(v) for v in v2]}, f)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.plot([float(v) for v in v1], label=name1)
    plt.plot([float(v) for v in v2], label=name2)
    plt.title("Training " + title + " on Dataset")
    plt.xlabel("Epoch #")
    plt.ylabel(title)
    plt.legend(loc="lower left")
    path = os.path.join(model_dir, title + ".png")
    fig.savefig(path)
    plt.close(fig)
    return path
