"""Multi-device training: process groups, the data mesh, the 2-D mesh.

Port of multimodal_idbn_tpu/parallel/__init__.py, every public name under
the same name. The JAX package scales one program over a device mesh and
lets XLA insert the collectives; the port runs one process per device in a
``torch.distributed`` group (``initialize_distributed``) and sums the CD
statistics over it itself (``ops.shard``). Random draws are those of one
device whatever the split, so results agree with a single device up to the
order of the cross-process sums.
"""

from multimodal_idbn_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    is_main_process,
    is_multi_process,
    local_batch_slice,
)
from multimodal_idbn_tpu_torch.parallel.data_parallel import (  # noqa: F401
    Mesh,
    batch_sharding,
    dp_bimodal_epoch_block,
    dp_bimodal_joint_epoch,
    dp_cd_update,
    dp_idbn_epoch,
    dp_idbn_epoch_block,
    dp_joint_epoch,
    dp_joint_epoch_block,
    make_mesh,
    pad_to_multiple,
    replicate,
    resolve_mesh,
    shard_batch,
)
from multimodal_idbn_tpu_torch.parallel.mesh2d import (  # noqa: F401
    Mesh2D,
    gather_state,
    make_mesh_2d,
    shard_batch_2d,
    shard_state,
    state_pspecs,
    tp_cd_update,
    tp_idbn_epoch,
)
