"""The negacyclic NTT with its coefficient matrix split over a mesh axis —
the port of ``herdsman_tpu.mesh.ntt_sharded`` (SURVEY.md §5, BASELINE
configs 4/5).

The four-step NTT views a polynomial as the matrix [N1, N2].  Split over D
positions by rows (n1), the pre-twist is local; the first DFT contracts
over n1, so an all-to-all turns the row shares into column shares (n2)
and each position transforms its N2/D columns over all n1; the twiddle is
local; the second DFT contracts over n2, so a second all-to-all turns the
column shares back into row shares (k1) and each position transforms its
N1/D rows.  The inverse runs the mirror schedule.  Each all-to-all moves
(D-1)/D of the matrix once, where the JAX package all-gathers the whole
matrix to every position; the bits are the same, since every product is
``ops.ntt._mod_matmul_digits`` on the same rows.  The shares are placed on
their positions' devices before each call (``ops.ntt`` refuses a tensor
on another device), through each device's own plan.
"""

from __future__ import annotations

import numpy as np
import torch

from herdsman_tpu_torch.mesh.sharding import Mesh
from herdsman_tpu_torch.ops import modmath as mm
from herdsman_tpu_torch.ops import ntt as nttm
from herdsman_tpu_torch.ops.u32 import on_device

I32 = torch.int32
I64 = torch.int64


def _positions(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis`` through this process's first position:
    the shares of one transform."""
    b, l = np.argwhere(mesh.processes == mesh.rank)[0]
    index = (b, slice(None)) if axis == "limb" else (slice(None), l)
    if (mesh.processes[index] != mesh.rank).any():
        raise ValueError(f"the mesh's {axis} axis crosses a process")
    return list(mesh.devices[index])


def _plans(plan: nttm.NTTPlan, mesh: Mesh, axis: str) -> list[nttm.NTTPlan]:
    plans = [nttm.make_plan(plan.p, plan.N, device=d)
             for d in _positions(mesh, axis)]
    D = len(plans)
    if plan.N1 % D or plan.N2 % D:
        raise ValueError(f"[{plan.N1}, {plan.N2}] does not split over "
                         f"{D} positions")
    return plans


def _exchange(shares: list[torch.Tensor], plans: list[nttm.NTTPlan],
              split_dim: int, cat_dim: int) -> list[torch.Tensor]:
    """All-to-all: position j gets block j (along ``split_dim``) of every
    share, concatenated along ``cat_dim`` on its device, as int32 (the
    residues are below 2^23)."""
    D = len(plans)
    blocks = [s.to(I32).chunk(D, dim=split_dim) for s in shares]
    return [torch.cat([bl[j].to(pl.device) for bl in blocks], dim=cat_dim)
            for j, pl in enumerate(plans)]


def _rows(t: torch.Tensor, j: int, D: int) -> torch.Tensor:
    return t.chunk(D, dim=0)[j].to(I64)


def ntt_fwd_sharded(plan: nttm.NTTPlan, mesh: Mesh, x,
                    axis: str = "limb") -> torch.Tensor:
    """Negacyclic forward NTT with the coefficient matrix split over
    ``axis``: x [..., N] residues -> the spectrum [..., N] on the plan's
    device, equal to ``ops.ntt.ntt_fwd``."""
    plans = _plans(plan, mesh, axis)
    D = len(plans)
    x = on_device(x, plan.device)
    lead = x.shape[:-1]
    m = x.reshape(*lead, plan.N1, plan.N2)
    shares = []
    for j, pl in enumerate(plans):   # pre-twist the n1 rows of each share
        psi = _rows(pl.psi_mont.view(pl.N1, pl.N2), j, D)
        share = m.chunk(D, dim=-2)[j].to(pl.device)
        shares.append(mm._mont_mul(share.to(I64), psi, pl.ctx))
    cols = _exchange(shares, plans, split_dim=-1, cat_dim=-2)
    shares = []
    for j, (c, pl) in enumerate(zip(cols, plans)):
        # DFT over n1 of this share's N2/D columns: y[k1, n2]
        y = nttm._mod_matmul_digits(c.transpose(-1, -2), pl.w1_dig, pl.N1,
                                    pl.p, pl.ctx.mu).transpose(-1, -2)
        tw = pl.tw_mont.chunk(D, dim=1)[j].to(I64)
        shares.append(mm._mont_mul(y, tw, pl.ctx))
    rows = _exchange(shares, plans, split_dim=-2, cat_dim=-1)
    out = [nttm._mod_matmul_digits(r, pl.w2_dig, pl.N2, pl.p, pl.ctx.mu)
           for r, pl in zip(rows, plans)]   # DFT over n2 of the k1 rows
    spec = torch.cat([o.to(I32).to(plan.device) for o in out], dim=-2)
    return spec.reshape(*lead, plan.N)


def ntt_inv_sharded(plan: nttm.NTTPlan, mesh: Mesh, spec,
                    axis: str = "limb") -> torch.Tensor:
    """Inverse of ``ntt_fwd_sharded``: [..., N] spectrum -> [..., N]
    residues on the plan's device, equal to ``ops.ntt.ntt_inv``."""
    plans = _plans(plan, mesh, axis)
    D = len(plans)
    spec = on_device(spec, plan.device)
    lead = spec.shape[:-1]
    s = spec.reshape(*lead, plan.N1, plan.N2)
    shares = []
    for j, pl in enumerate(plans):   # undo the k2 DFT of each k1 share
        share = s.chunk(D, dim=-2)[j].to(pl.device)
        z = nttm._mod_matmul_digits(share, pl.w2i_dig, pl.N2, pl.p,
                                    pl.ctx.mu)
        shares.append(mm._mont_mul(z, _rows(pl.twi_mont, j, D), pl.ctx))
    cols = _exchange(shares, plans, split_dim=-1, cat_dim=-2)
    shares = [nttm._mod_matmul_digits(c.transpose(-1, -2), pl.w1i_dig,
                                      pl.N1, pl.p, pl.ctx.mu
                                      ).transpose(-1, -2)
              for c, pl in zip(cols, plans)]   # undo the n1 DFT
    rows = _exchange(shares, plans, split_dim=-2, cat_dim=-1)
    out = []
    for j, (r, pl) in enumerate(zip(rows, plans)):   # post-twist, / N
        psi = _rows(pl.psi_inv_mont.view(pl.N1, pl.N2), j, D)
        out.append(mm._mont_mul(r.to(I64), psi, pl.ctx).to(I32))
    x = torch.cat([o.to(plan.device) for o in out], dim=-2)
    return x.reshape(*lead, plan.N)


def polymul_sharded(plan: nttm.NTTPlan, mesh: Mesh, a, b,
                    axis: str = "limb") -> torch.Tensor:
    """Negacyclic product mod p with both transforms split over ``axis``,
    equal to ``ops.ntt.negacyclic_polymul_ntt``."""
    sa = ntt_fwd_sharded(plan, mesh, a, axis)
    sb = ntt_fwd_sharded(plan, mesh, b, axis)
    return ntt_inv_sharded(plan, mesh, nttm.pointwise_mul(plan, sa, sb),
                           axis)
