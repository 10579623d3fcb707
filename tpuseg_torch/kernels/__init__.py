"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

* ``conv3d``     — small-channel 3x3x3 SAME conv, forward, dX and dW
  (tpuseg/kernels/conv3d.py; ``csrc/conv3d_small.cu``,
  ``csrc/conv3d_small_dw.cu``)
* ``fused_norm`` — fused GroupNorm+ReLU, forward and backward
  (tpuseg/kernels/fused_norm.py; ``csrc/fused_norm.cu``,
  ``csrc/fused_norm_bwd.cu``)

Sources live in ``csrc/`` and are built on first use by ``_build``.
"""
