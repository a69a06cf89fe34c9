"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference. This package grows beside
it slice by slice, keeping ``repro``'s module layout so every module has
an obvious counterpart:

  prng        threefry keys and draws, bit for bit as ``jax.random``
  analog/     sign-magnitude WBS quantizer, bit planes, mid-rise ADC,
              the crossbar and G⁺/G⁻ pair models, endurance, cost model
  core/       MiRU cell/forward/readout, ζ (k-WTA), DFA gradients, the
              replay buffer, the continual-learning trainer
  kernels/    hand-written CUDA kernels (``csrc/``), their plain PyTorch
              versions (``ref.py``) and the padded wrappers (``ops.py``)
  backends/   the DeviceBackend protocol, ``ideal``, ``wbs``, ``analog``,
              ``analog_state`` and ``cmos``
  replay/     host replay policies and their registry
  data/       the synthetic task streams
  telemetry/  eager activity counters, metered energy, lifetime, Table I
  obs/        the latency histogram
  serve/      state slab, traffic generator, continuous-batching engine

It imports torch and numpy only — never jax and never ``repro``. Entry
points run on ``cuda`` unless the caller asks for the CPU; on a CPU
tensor every kernel wrapper uses its plain version, on a CUDA tensor it
launches the kernel or raises.
"""

__version__ = "0.1.0"
