"""tpuseg_torch — the PyTorch/CUDA port of tpuseg for NVIDIA Hopper (H100).

The package mirrors ``tpuseg/``'s layout and names so that each module's
JAX counterpart is easy to find.  It imports ``torch`` and never ``jax``.

Layout convention, as in tpuseg: channels-last activations at every public
function (NDHWC for 3D) and DHWIO conv kernels at the kernel wrappers.
Module parameters use the reference PyTorch framework's names and layouts
(``compat/weights.py``), so reference ``.pth`` files load with
``strict=True``.

The serving path (``serve``) and the training path (``train``) run the
small-channel 3x3x3 conv and the fused GroupNorm+ReLU, forward and
backward, through hand-written CUDA kernels (``kernels/``), built with
``nvcc`` for ``sm_90a`` at first use.  On CPU tensors those wrappers run
their plain PyTorch versions; on CUDA tensors they launch the kernels or
raise.
"""

__version__ = "0.1.0"
