"""Dictionary update rules: counterpart of vtc_tpu/dict_update_rules/
__init__.py:1-13.

Like the JAX package, every ``run`` RETURNS the new dictionary instead of
mutating it in place.  The fully-connected sparse-coding and subspace
rules and the convolutional sparse-coding rules are ported; the ICA rule
waits (ROADMAP.md §1 item 6).
"""
from vtc_tpu_torch.dict_update_rules import convolutional  # noqa: F401
from vtc_tpu_torch.dict_update_rules.fully_connected import (  # noqa: F401
    sc_cheap_quadratic_descent, sc_steepest_descent,
    subspace_sc_cheap_quadratic_descent, subspace_sc_steepest_descent)
