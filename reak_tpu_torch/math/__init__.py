"""Math helpers (port of ``reak_tpu.math``): the lanes-layout rotations."""
