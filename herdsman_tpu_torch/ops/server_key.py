"""Device-resident evaluation key material, in the layouts the port consumes.

The host server key (any object with ``.params``, ``.bsk`` [n, R, k+1, N]
and ``.ksk`` [kN, ks_levels, n+1] as numpy uint32 — the port's
``core.reference.ServerKey`` or the JAX package's) is carried to the device
once, into:

- ``bsk``       int32 [n, R, k+1, N]   the raw bootstrapping key (R =
                                       (k+1)*levels GGSW rows), the layout
                                       the ``mega13`` CUDA kernel reads.  At
                                       STD128_K2 it is 27 MiB, so the whole
                                       key stays resident in the H100's
                                       50 MB L2 and needs no expansion.
- ``bsk_ext``   int32 [n, R, k+1, 2N]  ext(p) = concat(p, -p) of every key
                                       polynomial: the Toeplitz gather table
                                       of the plain version.
- ``ksk_limbs`` int8  [kN*t, C]        the key-switching key as balanced int8
                                       limbs for one ``torch._int_mm``;
                                       C = (n+1)*4 padded to a multiple of 8,
                                       which the CUDA int8 matmul requires.
"""

from __future__ import annotations

import dataclasses

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, resolve_device

LAYOUTS = ("bsk", "bsk_ext")


@dataclasses.dataclass(frozen=True)
class DeviceServerKey:
    params: TFHEParams
    device: torch.device
    ksk_limbs: torch.Tensor             # int8 [kN*ks_levels, ceil8((n+1)*4)]
    bsk: torch.Tensor | None = None     # int32 [n, R, k+1, N]
    bsk_ext: torch.Tensor | None = None  # int32 [n, R, k+1, 2N]

    @property
    def R(self) -> int:
        p = self.params
        return (p.k + 1) * p.levels

    def check_device(self, device: torch.device) -> torch.device:
        """``device`` if the key lives there; raise otherwise."""
        if device != self.device:
            raise ValueError(f"the server key is on {self.device}, "
                             f"not on {device}")
        return device


def bt_tile(params: TFHEParams) -> tuple[int, int]:
    """(P, HALF) of the JAX package's block-Toeplitz tiling: P = min(128, N),
    HALF = N/P.  The port's layouts do not tile; this names the geometry
    that the TPU kernels' shapes are quoted in."""
    P = min(128, params.N)
    return P, params.N // P


def device_server_key(sk, layouts: tuple[str, ...] = LAYOUTS,
                      device: str | torch.device = "cuda") -> DeviceServerKey:
    """Carry a host server key to ``device`` in the layouts named."""
    dev = resolve_device(device)
    unknown = set(layouts) - set(LAYOUTS)
    if unknown:
        raise ValueError(f"unknown key layouts {sorted(unknown)}; "
                         f"known: {LAYOUTS}")
    # the port's own TFHEParams, whichever package's key this is
    p = TFHEParams(**{f.name: getattr(sk.params, f.name)
                      for f in dataclasses.fields(TFHEParams)})
    R = (p.k + 1) * p.levels
    if tuple(sk.bsk.shape) != (p.n, R, p.k + 1, p.N):
        raise ValueError(f"bsk shape {sk.bsk.shape} != "
                         f"{(p.n, R, p.k + 1, p.N)} for {p.name}")
    if tuple(sk.ksk.shape) != (p.kN, p.ks_levels, p.n + 1):
        raise ValueError(f"ksk shape {sk.ksk.shape} != "
                         f"{(p.kN, p.ks_levels, p.n + 1)} for {p.name}")

    bsk = from_numpy_u32(sk.bsk, dev)
    ksk = from_numpy_u32(sk.ksk, dev)
    cols = (p.n + 1) * 4
    ksk_limbs = poly.to_i8_limbs(ksk).reshape(p.kN * p.ks_levels, cols)
    ksk_limbs = torch.nn.functional.pad(ksk_limbs, (0, (-cols) % 8))
    return DeviceServerKey(
        params=p,
        device=dev,
        ksk_limbs=ksk_limbs.contiguous(),
        bsk=bsk if "bsk" in layouts else None,
        bsk_ext=(poly.negacyclic_extend(bsk).contiguous()
                 if "bsk_ext" in layouts else None),
    )
