"""Numerical core of the port: precision pins, thresholds, the solver
loop, the Lipschitz stepsize and the wrappers of the fused FISTA, fused
train step, fused group FISTA and fused group train step kernels."""
