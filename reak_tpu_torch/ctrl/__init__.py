"""Control (port of ``reak_tpu.ctrl``): the lanes Riccati PDIP and the
batched KTE-MPC solver."""
