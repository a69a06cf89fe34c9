"""Hand-written CUDA kernels for Hopper and their plain versions.

- ``csrc/``: the CUDA C++ sources (``wbs_matmul.cu``, ``wbs_miru_scan.cu``
  and their shared ``wbs_common.cuh``; ``miru_scan.cu``,
  ``miru_readout.cu``), built by :mod:`._build`.
- ``wbs_matmul``, ``wbs_miru_scan``, ``miru_scan``, ``miru_readout``: the
  ctypes wrappers of the kernels, CUDA tensors only, each with a
  ``launches`` counter (``wbs_matmul`` also ``read_noise_launches``).
- ``ref``: the plain PyTorch versions, bitwise equal to the kernels.
- ``ops``: padding and device dispatch — what the backends and the
  MiRU forward call.
"""
