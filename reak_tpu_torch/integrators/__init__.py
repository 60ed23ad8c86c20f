"""ODE integrators (port of ``reak_tpu.integrators``; ref:
core/integrators/integrator.hpp:102,153, fixed_step_integrators.hpp,
variable_step_integrators.hpp, pred_corr_integrators.hpp).

Every stepper is a pure function ``(f, t, y, dt) → y'`` lifted into a
Python loop (a ``lax.scan`` in JAX); the adaptive methods reject steps
inside a bounded loop whose condition stays on the device and is read on
the host every ``check_every`` attempts (``integrators/adaptive.py``).
"""
from reak_tpu_torch.integrators.fixed import (
    euler_step,
    midpoint_step,
    rk4_step,
    rk5_step,
    integrate,
    rollout,
)
from reak_tpu_torch.integrators.adaptive import (rkf45_step, dopri45_step,
                                                 integrate_adaptive)
from reak_tpu_torch.integrators.multistep import (adams_bm3, adams_bm5,
                                                  hamming_mod,
                                                  hamming_iter_mod)

__all__ = [
    "euler_step",
    "midpoint_step",
    "rk4_step",
    "rk5_step",
    "integrate",
    "rollout",
    "rkf45_step",
    "dopri45_step",
    "integrate_adaptive",
    "adams_bm3",
    "adams_bm5",
    "hamming_mod",
    "hamming_iter_mod",
]
