"""Hand-written CUDA kernels and their wrappers (port of ``reak_tpu.ops``).

Each module binds the kernels of one ``reak_tpu_torch/csrc`` source (the
core kernel of ``ops/kte_core.py`` is the second instance of
``kte_step.cu``) and keeps their plain torch versions beside them;
importing a module needs neither CUDA nor nvcc.  ``chol_lanes`` is
exported as the JAX package exports it, imported at its first use (it
imports ``ctrl``, which imports this package)."""
import importlib

__all__ = ["chol_lanes"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
