"""Batched boolean gate evaluation (booleans encoded as +-q/8 LWE) — the
port of ``herdsman_tpu.ops.gates``.

Every standard two-input gate is
    bootstrap_bool( w1*c1 + w2*c2 + (0,...,0, bias) )
with per-gate (w1, w2, bias), so a heterogeneous batch of gates (one circuit
level) is one linear combine and one batched bootstrap: one launch of the
blind-rotation kernel.  NOT is linear (no bootstrap); MUX is two raw
bootstraps, run here as one batch of 2B, and one key switch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.ops.u32 import resolve_device, to_device, u32_const

I32 = torch.int32

Q8 = 1 << 29   # q/8
Q4 = 1 << 30   # q/4

# gate -> (w1, w2, bias) for the pre-bootstrap linear combination
GATE_COEFFS: dict[str, tuple[int, int, int]] = {
    "AND":  (1, 1, -Q8),
    "OR":   (1, 1, Q8),
    "NAND": (-1, -1, Q8),
    "NOR":  (-1, -1, -Q8),
    "XOR":  (2, 2, Q4),
    "XNOR": (-2, -2, -Q4),
}

GATE_IDS: dict[str, int] = {g: i for i, g in enumerate(GATE_COEFFS)}

# [gates, 3] int32 carrier of (w1, w2, bias); moved to the device per call
_COEFF_NP = np.array([[u32_const(v) for v in c] for c in GATE_COEFFS.values()],
                     dtype=np.int32)


class GateBatch(NamedTuple):
    """A heterogeneous batch of two-input gates (one circuit level)."""

    gate_ids: object  # [B] ints, indices into GATE_COEFFS order
    c1: object        # [B, n+1] numpy uint32 or int32 carrier tensor
    c2: object        # [B, n+1]


def gate_linear(p_n: int, gate_ids: torch.Tensor, c1: torch.Tensor,
                c2: torch.Tensor) -> torch.Tensor:
    """Per-element w1*c1 + w2*c2 + bias on the body: [B, n+1]."""
    coeffs = torch.from_numpy(_COEFF_NP).to(c1.device)[gate_ids.long()]
    lin = coeffs[:, 0:1] * c1 + coeffs[:, 1:2] * c2
    lin[:, p_n] += coeffs[:, 2]
    return lin


def gate_batch(dsk: DeviceServerKey, batch: GateBatch, engine: str = "mega13",
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Evaluate a heterogeneous batch of two-input gates: [B, n+1] out."""
    dev = dsk.check_device(resolve_device(device))
    ids = torch.as_tensor(batch.gate_ids, device=dev)
    lin = gate_linear(dsk.params.n, ids, to_device(batch.c1, dev),
                      to_device(batch.c2, dev))
    return bs.bootstrap_bool_batch(dsk, lin, engine=engine, device=dev)


def gate_not(ct: torch.Tensor) -> torch.Tensor:
    """NOT is ciphertext negation — linear, no bootstrap."""
    return -ct


def mux_batch(dsk: DeviceServerKey, sel, a, b, engine: str = "mega13",
              device: str | torch.device = "cuda") -> torch.Tensor:
    """Batched MUX(sel, a, b) = AND(sel, a) + AND(!sel, b) + q/8: two raw
    bootstraps (one rotation of 2B ciphertexts) and one key switch."""
    dev = dsk.check_device(resolve_device(device))
    p = dsk.params
    sel, a, b = (to_device(x, dev) for x in (sel, a, b))
    lin = torch.cat([sel + a, b - sel])
    lin[:, p.n] -= Q8
    raw = bs.bootstrap_raw_batch(dsk, lin, bs.make_test_poly(p, device=dev),
                                 engine=engine)
    t1, t2 = raw.chunk(2)
    u = t1 + t2
    u[:, p.kN] += Q8
    return bs.key_switch_batch(dsk, u)
