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


# JAX's precision names (multimodal_idbn_tpu/config.py:47-62) -> torch's.
MATMUL_PRECISIONS = {"highest": "highest", "high": "high",
                     "default": "medium"}


def set_matmul_precision(precision: str = "highest") -> None:
    """Pin the precision of fp32 matrix products, the port's counterpart
    of JAX's ``config.set_matmul_precision`` (config.py:47-62); the entry
    points call it with ``training.matmul_precision`` (default
    "highest", true fp32, the reference's numerics: CD training is
    precision-sensitive).

    ``highest`` -> ``torch.set_float32_matmul_precision("highest")``,
    ``high`` -> ``"high"``, ``default`` -> ``"medium"``. The names match,
    the arithmetic does not: XLA's ``high`` is three bf16 passes (about
    fp32 accuracy), torch's ``high`` is one TF32 pass (10-bit mantissa);
    XLA's ``default`` is one bf16 pass, torch's ``medium`` is bf16 where
    the backend offers it. The setting governs the cuBLAS products of the
    plain torch code only. The port's CUDA kernels keep their 3×TF32
    tiles (fp32 accuracy) whatever it says, as JAX's Pallas half-step
    fixes its operands at bf16 (pallas_kernels.py:215-225) whatever the
    global setting is. The setting is global to the process, as JAX's."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r} "
                         f"({' | '.join(MATMUL_PRECISIONS)})")
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[precision])


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA request without a GPU raises.

    The precision of fp32 products is left to ``set_matmul_precision``
    (torch's default is true fp32, "highest")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(or --device cpu) to run on the CPU")
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
