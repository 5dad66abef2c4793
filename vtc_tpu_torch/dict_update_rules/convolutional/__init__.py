"""Convolutional dictionary update rules: counterpart of
vtc_tpu/dict_update_rules/convolutional/__init__.py."""
