"""Hand-written CUDA kernels for Hopper and their plain versions.

- ``csrc/``: the CUDA C++ sources (``wbs_matmul.cu``, ``wbs_miru_scan.cu``
  and their shared ``wbs_common.cuh``; ``miru_scan.cu``,
  ``miru_readout.cu``, ``flash_attention_fwd.cu``,
  ``flash_attention_bwd.cu``, ``kwta.cu``), built by :mod:`._build`.
- ``wbs_matmul``, ``wbs_miru_scan``, ``miru_scan``, ``miru_readout``,
  ``flash_attention``, ``kwta``: the ctypes wrappers of the kernels, CUDA
  tensors only, each with a ``launches`` counter (``wbs_matmul`` also
  ``read_noise_launches``, ``flash_attention`` also ``dq_launches`` and
  ``dkv_launches`` for the backward's two kernels).
- ``ref``: the plain PyTorch versions, bitwise equal to the kernels (the
  flash forward's and backward's at fp32 tolerance).
- ``ops``: padding and device dispatch — what the backends, the MiRU
  forward and the LM's attention call; the flash forward's autograd
  Function, whose gradient is the backward's kernels.
"""
