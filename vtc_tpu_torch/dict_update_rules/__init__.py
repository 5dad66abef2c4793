"""Dictionary update rules: counterpart of vtc_tpu/dict_update_rules/
__init__.py:1-13.

Like the JAX package, every ``run`` RETURNS the new dictionary instead of
mutating it in place.  Every rule is ported: the fully-connected
sparse-coding, subspace and ICA (``ica_natural_gradient``) rules and the
convolutional sparse-coding rules.
"""
from vtc_tpu_torch.dict_update_rules import convolutional  # noqa: F401
from vtc_tpu_torch.dict_update_rules.fully_connected import (  # noqa: F401
    sc_cheap_quadratic_descent, sc_steepest_descent,
    subspace_sc_cheap_quadratic_descent, subspace_sc_steepest_descent)
