"""Hopper counterparts of the JAX package's K2 micro-benchmarks.

Each module is one probe of ``benchmarks/`` and runs on the card by default
(``python -m tpuseg_torch.benchmarks.<name>``), or on the CPU through the
kernels' plain versions when its ``run`` is given ``device="cpu"``:

* ``kmicro``  — ``benchmarks/kmicro_r2.py`` (K4): the slab conv GEMM alone
  (``dot_only``), with its A build (``abuild``), whole (``full``), and the
  layout round trip;
* ``kmicro2`` — ``benchmarks/kmicro2_r2.py`` (K5): the GEMM's shape
  variants;
* ``kmicro3`` — ``benchmarks/kmicro3_r2.py`` (K6): the flat channels-last
  formulation, xcat prebuilt or built in the kernel, and the build alone;
* ``kbench``  — ``benchmarks/kbench_r2.py``: a chain of six bf16 3x3x3
  convs through K2 (``conv3d_small``) against cuDNN.

``common`` holds the timing, the useful-FLOP count, the bounds and the
line format.
"""
