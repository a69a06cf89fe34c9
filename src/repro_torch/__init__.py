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
  configs/    the model configs (``ModelConfig``, one module each)
  models/     the LM zoo's dense, moe, ssm and hybrid families: layers,
              GQA attention and the bf16/int8 KV caches, the MoE FFN, the
              mamba2 SSD mixer, the layer stacks and jamba's superblocks,
              the top-level model
  optim/      the optax-style optimizers (AdamW), ζ sparsification and
              top-k compression
  train/      the LM trainer, checkpoint/restart, fault tolerance
  backends/   the DeviceBackend protocol, ``ideal``, ``wbs``, ``analog``,
              ``analog_state`` and ``cmos``
  replay/     host replay policies and their registry
  data/       the synthetic task streams, the deterministic batcher
  telemetry/  eager activity counters, metered energy, lifetime, Table I
  obs/        per-step metric streams (RunLog), span tracer, run-record
              sinks, the latency histogram
  scenarios/  the scenario registry, continual-learning metrics, the
              compiled whole-sequence run and the scenario × backend
              sweep
  serve/      state slab, traffic generator, continuous-batching engine
              for MiRU streams; the slot-based LM decode engine
  faults/     stuck cells, dead lines, read upsets, wear-out, and the
              mitigation stack (march self-test, column remap, bias
              compensation, recalibration)
  fleet/      a fleet of heterogeneous chips through one stream, and its
              population distributions

It imports torch and numpy only — never jax and never ``repro``. Entry
points run on ``cuda`` unless the caller asks for the CPU; on a CPU
tensor every kernel wrapper uses its plain version, on a CUDA tensor it
launches the kernel or raises.
"""

__version__ = "0.1.0"
