"""Optimization toolbox: line searches, root finders, NLLSQ, NLP,
constrained (port of ``reak_tpu/opt``).

Re-design of the reference's `core/optimization` (30 files, ~15.1k LoC —
line_search.hpp, quadratic_programs.hpp, gauss_newton_method.hpp,
levenberg_marquardt_method.hpp, quasi_newton_methods.hpp, newton_methods.hpp,
nonlin_conjugate_gradient_methods.hpp, augmented_lagrangian_methods.hpp,
sequential_qp_methods.hpp:196, nl_interior_points_methods.hpp:1215,
finite_diff_jacobians.hpp) and `core/root_finders` (bisection_method.hpp:58,
secant_method.hpp:249, newton_raphson_method.hpp:63, broyden_method.hpp).

Design stance: every solver is a pure function of ONE problem with a
**static iteration budget** (a Python loop of fixed length and
``torch.where`` selects), so ``torch.func.vmap`` maps the whole solve over
thousands of problem instances — the batched regime the reference runs
serially.  Plain torch on the device and in the type of the inputs (numbers
and numpy arrays become float64 tensors on the card: pass CPU tensors to
solve on the CPU); no kernel.  The LP solver lives in :mod:`reak_tpu_torch.opt.lp`; convex QP
solvers (the MPC core) in :mod:`reak_tpu_torch.ctrl.qp`.
"""
from reak_tpu_torch.opt.line_search import (
    backtracking_armijo,
    golden_section,
    dichotomous_search,
    wolfe_zoom,
)
from reak_tpu_torch.opt.root_finders import (
    bisection,
    secant,
    illinois,
    ridders,
    brent,
    newton_raphson,
    broyden,
)
from reak_tpu_torch.opt.nllsq import (
    gauss_newton,
    levenberg_marquardt,
    jacobian_transpose,
    NLLSQResult,
)
from reak_tpu_torch.opt.nlp import (
    nelder_mead,
    bfgs,
    sr1_trust_region,
    nonlinear_cg,
    newton_method,
    NLPResult,
)
from reak_tpu_torch.opt.constrained import (
    augmented_lagrangian,
    sqp_equality,
    log_barrier,
    ConstrainedResult,
)
from reak_tpu_torch.opt.finite_diff import fd_gradient, fd_jacobian, fd_hessian

__all__ = [
    "backtracking_armijo", "golden_section", "dichotomous_search", "wolfe_zoom",
    "bisection", "secant", "illinois", "ridders", "brent", "newton_raphson",
    "broyden",
    "gauss_newton", "levenberg_marquardt", "jacobian_transpose", "NLLSQResult",
    "nelder_mead", "bfgs", "sr1_trust_region", "nonlinear_cg", "newton_method",
    "NLPResult",
    "augmented_lagrangian", "sqp_equality", "log_barrier", "ConstrainedResult",
    "fd_gradient", "fd_jacobian", "fd_hessian",
]
