"""Hand-written CUDA kernels for Hopper and their plain versions.

- ``csrc/``: the CUDA C++ sources (``wbs_matmul.cu``, ``wbs_miru_scan.cu``
  and their shared ``wbs_common.cuh``; ``miru_scan.cu``,
  ``miru_readout.cu``, ``kwta.cu``, and the tensor-core flash kernels
  ``flash_attention_*_sm90.cu`` with their ``flash_sm90.cuh`` and
  ``flash_f32_sm90.cuh``), built by :mod:`._build`.
- ``wbs_matmul``, ``wbs_miru_scan``, ``miru_scan``, ``miru_readout``,
  ``flash_attention``, ``kwta``: the ctypes wrappers of the kernels, CUDA
  tensors only, each with a launch counter (``launches``; ``wbs_matmul``
  also ``read_noise_launches``, ``flash_attention`` one for each of its
  six kernels).
- ``ref``: the plain PyTorch versions, bitwise equal to the kernels (the
  flash forward's and backward's at fp32 tolerance).
- ``ops``: padding and device dispatch — what the backends, the MiRU
  forward and the LM's attention call; the flash forward's autograd
  Function, whose gradient is the backward's kernels.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
