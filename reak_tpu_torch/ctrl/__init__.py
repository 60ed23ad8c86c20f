"""Control (port of ``reak_tpu.ctrl``): the batched KTE-MPC solvers, the
Riccati PDIPs, the scenario MPC on manifolds, the generic MPC, the dense
QPs, the vehicle models, beliefs, the Kalman-family filters (EKF, IEKF,
UKF, TSOS), belief prediction, LQR/LQG, estimator options and the AQR
topologies."""
