"""Numerical core of the port: precision pins, thresholds, the solver
loop, the Lipschitz stepsize and the fused FISTA kernel wrapper."""
