"""Hand-written Hopper kernels: build, bind and wrap.

Counterpart of ``torchdr_tpu/ops/pallas/``. The CUDA sources live in
``ops/csrc/``; :mod:`.build` compiles each into a C-ABI shared library with
``nvcc`` at first use and loads it with ``ctypes``.
"""
