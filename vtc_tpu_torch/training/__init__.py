"""Trainer orchestration for fully-connected sparse coding and its
subspace (group-sparse) variant: counterpart of
vtc_tpu/training/__init__.py.

``sparse_coding.train_dictionary`` runs one fused step per batch from
Python; ``compiled_epoch.train_dictionary_scanned`` runs whole segments,
through the fused train kernels (ops/fused_train_step, or
ops/fused_group_train_step with groups) on a CUDA device.
ICA and PCA wait (ROADMAP.md §1 item 6).
"""
