"""Device selection for the port's entry points.

No JAX counterpart: JAX picks its backend itself. The port runs on
``cuda`` unless the caller asks for the CPU, and never drifts to the CPU
when no GPU is present.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA request without a GPU raises.

    On the card, TF32 is switched off for matrix products and cuDNN: the
    flagship YAML pins ``matmul_precision: highest`` (true fp32), and CD
    training is precision-sensitive (multimodal_idbn_tpu/config.py:47-58).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(or --device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy / torch input -> 2-D float32 tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.float32).to(device)
    if t.ndim > 2:
        t = t.reshape(t.shape[0], -1)
    return t.contiguous()


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card before reading a host clock (no-op on CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
