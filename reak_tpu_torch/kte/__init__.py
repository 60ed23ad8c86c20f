"""KTE multibody dynamics (port of ``reak_tpu.kte``): chain specs, the
flagship arm, forward kinematics and the lanes rollout."""
