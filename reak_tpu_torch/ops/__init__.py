"""Hand-written CUDA kernels and their wrappers (port of ``reak_tpu.ops``).

Each module binds one kernel of ``reak_tpu_torch/csrc`` and keeps its plain
torch version beside it; importing a module needs neither CUDA nor nvcc."""
