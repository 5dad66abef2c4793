"""Trainer orchestration for fully-connected sparse coding, its subspace
(group-sparse) variant, convolutional sparse coding, ICA and PCA:
counterpart of vtc_tpu/training/__init__.py.

``sparse_coding.train_dictionary`` runs one step per batch from Python
(conv: K10's solve on a CUDA device); ``compiled_epoch.
train_dictionary_scanned`` runs whole fc, subspace and conv segments,
through the fused train kernels on a CUDA device (ops/fused_train_step,
ops/fused_group_train_step with groups, ops/fused_conv_train in conv
mode), and ``compiled_epoch._code_shard_segment_runner`` runs the
residual-form segment for big dictionaries (ops/fused_code_shard_train).
``ica`` and ``pca`` train the ICA and PCA transforms (ops/fused_ica_train
on a CUDA device).  ``reset_prune`` is the port's copy of vtc_tpu's
numpy-only module.
"""
