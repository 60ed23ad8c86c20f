"""Math helpers (port of ``reak_tpu.math``): batched linear algebra, the
Riccati equation solvers, rotations (per point and in the lanes layout)
and kinematic frames."""
