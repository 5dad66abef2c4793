"""Trainer orchestration for fully-connected sparse coding, its subspace
(group-sparse) variant and convolutional sparse coding: counterpart of
vtc_tpu/training/__init__.py.

``sparse_coding.train_dictionary`` runs one step per batch from Python
(conv: K10's solve on a CUDA device); ``compiled_epoch.
train_dictionary_scanned`` runs whole fc and subspace segments, through
the fused train kernels (ops/fused_train_step, or
ops/fused_group_train_step with groups) on a CUDA device; its conv
branch waits for K12.  ``reset_prune`` is the port's copy of vtc_tpu's
numpy-only module.  ICA and PCA wait (ROADMAP.md §1 item 6).
"""
