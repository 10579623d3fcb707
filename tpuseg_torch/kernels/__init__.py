"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

* ``conv3d``     — small-channel 3x3x3 SAME conv, forward, dX and dW, on
  the tensor cores: bf16, and f32 by 3xTF32 (tpuseg/kernels/conv3d.py;
  ``csrc/conv3d_small_tc.cu``, ``csrc/conv3d_small_dw_tc.cu``,
  ``csrc/conv3d_small_tf32.cu``, ``csrc/conv3d_small_dw_tf32.cu``,
  ``csrc/conv3d_tc.cuh``)
* ``fused_norm`` — fused GroupNorm+ReLU, forward and backward, two
  launches each (tpuseg/kernels/fused_norm.py; ``csrc/fused_norm.cu``,
  ``csrc/fused_norm_bwd.cu``, ``csrc/fused_norm.cuh``)
* ``packed_conv`` — structured space-to-depth packed k3 conv, forward, on
  ``wgmma`` in bf16 and by 3xTF32 in f32 (tpuseg/kernels/packed_conv.py;
  ``csrc/packed_conv_tc.cu``)
* ``conv_int8``  — the W8A8 int8 conv route's kernels: the conv on int8
  ``wgmma`` over an input brick staged whole or by channel chunks, dense
  or on a packed k3's structural rows, and the two-launch activation
  quantizer (JAX's ``_Int8Conv`` / ``_conv_int8``, XLA ops;
  ``csrc/conv_int8.cuh`` with its launches in ``conv_int8.cu`` and
  ``conv_int8_full.cu``, ``csrc/quantize_int8.cu``)
* ``slab_conv``  — the slab-layout conv GEMM of K2's micro-benchmarks K4
  and K5, bf16 tensor cores (benchmarks/kmicro_r2.py, kmicro2_r2.py;
  ``csrc/slab_conv.cu``)
* ``flat_conv``  — the flat channels-last conv of micro-benchmark K6, bf16
  tensor cores (benchmarks/kmicro3_r2.py; ``csrc/flat_conv.cu``)

Sources live in ``csrc/`` and are built on first use by ``_build``.
"""
from tpuseg_torch.kernels import (conv3d, conv_int8, flat_conv, fused_norm, packed_conv,
                                  slab_conv)

__all__ = ["conv3d", "conv_int8", "flat_conv", "fused_norm", "packed_conv", "slab_conv"]
