"""Hand-written CUDA kernels and their wrappers (port of ``reak_tpu.ops``).

Each module binds the kernels of one ``reak_tpu_torch/csrc`` source (the
core kernel of ``ops/kte_core.py`` is the second instance of
``kte_step.cu``) and keeps their plain torch versions beside them;
importing a module needs neither CUDA nor nvcc."""
