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
The package exports what the JAX package's does (``RBM``, ``iDBN``,
``iMDBN``, ``iMDBN_BiModal``, ``set_global_seed``, ``__version__``), and
``resolve_device``.
"""

from multimodal_idbn_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"

__all__ = ["RBM", "iDBN", "iMDBN", "iMDBN_BiModal", "set_global_seed",
           "__version__", "resolve_device"]

_MODEL_EXPORTS = {"RBM", "iDBN", "iMDBN", "iMDBN_BiModal", "set_global_seed"}


def __getattr__(name):
    # Lazy, as in multimodal_idbn_tpu/__init__.py:33-39, so that importing
    # ``multimodal_idbn_tpu_torch.ops`` does not load the model shells.
    if name in _MODEL_EXPORTS:
        import multimodal_idbn_tpu_torch.models as _models
        return getattr(_models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
