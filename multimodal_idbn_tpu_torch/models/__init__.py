"""Model shells of the port (multimodal_idbn_tpu/models)."""

from multimodal_idbn_tpu_torch.models.idbn import iDBN  # noqa: F401
from multimodal_idbn_tpu_torch.models.imdbn import iMDBN  # noqa: F401
from multimodal_idbn_tpu_torch.models.imdbn_bimodal import (  # noqa: F401
    iMDBN_BiModal)
from multimodal_idbn_tpu_torch.models.rbm import (  # noqa: F401
    RBM, set_global_seed)

__all__ = ["RBM", "iDBN", "iMDBN", "iMDBN_BiModal", "set_global_seed"]
