"""PyTorch/CUDA port of ``multimodal_idbn_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference this port is held against.
The port imports ``torch`` and numpy only. It trains the image+label
iMDBN (``train_multimodal``) and the bimodal iMDBN_BiModal
(``train_bimodal``). Their modality iDBNs train through a hand-written
fused half-step kernel (``csrc/half_step.cu``, which also holds the
probs-only and the resident sampled half-steps) and the joint RBMs'
clamped mean-field chains run in a hand-written chain kernel
(``csrc/chain.cu``). Every kernel wrapper launches its kernel on CUDA
tensors and runs the kernel's plain PyTorch version on CPU tensors. The
diagnostics of ``utils/`` (linear probes, PCA correlations, free energy,
convergence, neighbours, trajectories, snapshots, timers) log to any run
object with ``.log(dict)`` during training. Loaders without
``materialize()`` train batch by batch; ``parallel`` trains data-parallel
(and splits a layer's hidden units) over a ``torch.distributed`` group,
one process per device.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no such request they raise (``device.resolve_device``).
"""

from multimodal_idbn_tpu_torch.device import resolve_device  # noqa: F401
from multimodal_idbn_tpu_torch.models.rbm import (  # noqa: F401
    set_global_seed)
