"""The u32 carrier: ciphertexts as ``torch.int32`` holding the u32 bit pattern.

PyTorch has no usable unsigned 32-bit arithmetic on the CPU (add, sub and
``>>`` on ``torch.uint32`` raise ``NotImplementedError``), so every torus
element travels as int32.  Two's complement makes add, sub, mul, ``<<``,
``&``, ``|`` and ``^`` the same bit operations as on u32, wrapping mod 2^32.
Only the right shift differs: int32 ``>>`` is arithmetic, so a logical shift
masks the sign-filled bits off (`srl`).  Comparisons and division are never
used on ciphertext data.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def u32_const(v: int) -> int:
    """A u32 constant as the Python int whose int32 bit pattern it is."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the u32 pattern in int32 ``x`` by static s."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def from_numpy_u32(a: np.ndarray, device: str | torch.device = "cpu"
                   ) -> torch.Tensor:
    """numpy uint32 -> int32 carrier tensor on ``device`` (bit-identical)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 carrier tensor -> numpy uint32 (bit-identical, on the host)."""
    if t.dtype != I32:
        raise TypeError(f"expected an int32 carrier tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` is the default of every
    entry point and raises when no card is present: nothing falls back to
    the CPU unless the caller asks for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "herdsman_tpu_torch runs on an NVIDIA GPU and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(x, device: torch.device) -> torch.Tensor:
    """``to_device`` for operands of a plan or context that lives on
    ``device``: numpy is carried there, a tensor on another device
    raises instead of moving."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"the operand is on {x.device}, not on {device}")
    return to_device(x, device)


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy uint32 array or an int32 carrier tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != I32:
            raise TypeError(f"expected an int32 carrier tensor, got {x.dtype}")
        return x.to(device)
    return from_numpy_u32(x, device)
