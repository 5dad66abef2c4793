"""Multi-device execution on ``torch.distributed``: counterpart of
vtc_tpu/parallel."""
from vtc_tpu_torch.parallel.data_parallel import (
    build_dp_conv_fused_local_step, build_dp_fused_local_step,
    build_dp_group_fused_local_step, build_dp_local_step,
    build_pjit_train_step, build_shard_map_train_step)
from vtc_tpu_torch.parallel.mesh import (Mesh, dp_axes, make_mesh,
                                         resolve_mesh)
