"""Numerical core of the port: precision pins, thresholds, the solver
loop, the Lipschitz stepsize, the convolution operators, and the wrappers
of the fused FISTA, fused train step, fused group FISTA, fused group
train step and the two conv solve kernels."""
