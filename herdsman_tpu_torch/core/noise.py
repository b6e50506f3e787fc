"""Closed-form noise accounting for the TFHE stack (q = 2^32) — the port's
copy of ``herdsman_tpu.core.noise``, function for function (a test holds the
two equal on every parameter set).

This module promotes the margin arithmetic from docs/BENCH_LOG.md prose to
executable form so tests/test_noise.py can ASSERT that every parameter set
of record keeps its documented safety margin — a params or gadget change
that silently erodes a margin below its bar now fails CI instead of
surfacing as rare decrypt failures on hardware (round-2 verdict item 7).

Conventions (calibrated against the hardware measurements recorded in
docs/BENCH_LOG.md; every predicted margin below is CONSERVATIVE — at or
under the corresponding measured value):

- Torus units: absolute std-devs out of q = 2^32.
- Secret keys are uniform binary: E[s] = 1/2, E[s^2] = 1/2.
- BSK/external-product term: each of the n CMux steps accumulates
  (k+1) * l * N gadget-digit x key-noise products (digit variance Bg^2/12)
  plus the signed-decomposition rounding residual of (1 + kN)/2 live key
  coefficients (eps uniform in +-q / (2 Bg^l)).
  Calibration: STD128 predicts sigma_out = 2^-8.7 q (the figure documented
  in core/params.py), STD128_FAST predicts a 13.1-sigma gate margin vs
  13.9 measured, STD128_K2 14.2 vs 15.9 measured.
- KS term: kN * l_ks digit x KSK-noise products with E[s^2] = 1/2 on the
  accumulated output-key mask, plus the unsigned-decomposition rounding
  residual.  Calibration: STD128_SHORTINT predicts a per-PBS sigma of
  4.9e-4 q — exactly the per-block sigma_1 backed out of the measured
  6.88e-4 q two-PBS chain (BENCH_LOG "Post-rebalance margins").
- Mod-switch term (2N rotation window): all n + 1 rounding errors counted
  at full weight (s_j = 1), i.e. sigma_ms = step * sqrt((n + 1) / 12) with
  step = q / 2N.  This reproduces BENCH_LOG's "1.95e-3 q mod-switch floor"
  at N = 2048 and is a deliberate upper bound (binary keys halve the mask
  contribution in expectation).
"""

from __future__ import annotations

import math

from herdsman_tpu_torch.core.params import TFHEParams

Q = float(1 << 32)


def mod_switch_sigma(p: TFHEParams, coarse_bits: int = 0) -> float:
    """Std-dev (q units) of the phase error introduced by the q -> 2N
    modulus switch; ``coarse_bits`` models many-LUT's reduced-precision
    switch (each bit doubles the rounding step)."""
    step = Q / (p.two_N >> coarse_bits)
    return step * math.sqrt((p.n + 1) / 12.0) / Q


def blind_rotate_var(p: TFHEParams) -> float:
    """Variance (q^2 units) of the blind-rotation output noise."""
    digit_var = p.Bg ** 2 / 12.0
    key_term = (p.k + 1) * p.levels * p.N * digit_var * (p.glwe_std / Q) ** 2
    eps_var = (Q / p.Bg ** p.levels) ** 2 / 12.0 / Q ** 2
    resid_term = (1 + p.kN) / 2.0 * eps_var
    return p.n * (key_term + resid_term)


def key_switch_var(p: TFHEParams) -> float:
    """Variance (q^2 units) added by the kN -> n key switch."""
    digit_var = p.ks_base ** 2 / 12.0
    key_term = p.kN * p.ks_levels * digit_var * (p.lwe_std / Q) ** 2 / 2.0
    eps_var = (Q / p.ks_base ** p.ks_levels) ** 2 / 12.0 / Q ** 2
    resid_term = p.kN / 2.0 * eps_var
    return key_term + resid_term


def pbs_out_sigma(p: TFHEParams) -> float:
    """Std-dev (q units) of a fresh bootstrap output after key switch."""
    return math.sqrt(blind_rotate_var(p) + key_switch_var(p))


def gate_margin_sigma(p: TFHEParams) -> float:
    """Boolean-gate margin in sigmas: distance from the +-q/8 codeword to
    the q/16 decision boundary over the fresh bootstrap output noise —
    the same convention ``bench.py --metric noise`` measures (phase-error
    std of chained gate outputs vs the q/16 boundary)."""
    return (1.0 / 16.0) / pbs_out_sigma(p)


def packing_ks_var(p: TFHEParams) -> float:
    """Variance (q^2 units) added per coefficient by the LWE -> GLWE
    packing keyswitch (core.reference.pack_lwes): n * l_ks digit
    polynomials (N coefficients each) convolved against PKSK noise, plus
    the unsigned-decomposition residual on the n binary key bits."""
    digit_var = p.ks_base ** 2 / 12.0
    key_term = p.n * p.ks_levels * p.N * digit_var * (p.glwe_std / Q) ** 2
    eps_var = (Q / p.ks_base ** p.ks_levels) ** 2 / 12.0 / Q ** 2
    return key_term + p.n / 2.0 * eps_var


def glwe_frame_margin_sigma(p: TFHEParams) -> float:
    """Gate margin (sigmas, q/16 convention) for a value that round-trips
    a GLWE-DOMAIN INTERMEDIATE FRAME: fresh bootstrap output + packing
    keyswitch (store) + sample-extract-and-keyswitch (load).  The
    coordinator refuses `workers.mesh.glwe_frames` for parameter sets
    where this falls below the production bar (round-2 advisor finding:
    glwe frames were only ever validated at TOY params)."""
    var = (pbs_out_sigma(p) ** 2 + packing_ks_var(p) + key_switch_var(p))
    return (1.0 / 16.0) / math.sqrt(var)


def _half_window(msg_bits: int, carry_bits: int) -> float:
    """Half-width (q units) of one LUT slot in the padded working space
    (msg + carry + 1 padding bit)."""
    space = 1 << (msg_bits + carry_bits + 1)
    return 1.0 / (2.0 * space)


def shortint_unary_margin_sigma(p: TFHEParams, msg_bits: int = 2,
                                carry_bits: int = 2) -> float:
    """PBS decision margin (sigmas) for a FRESH unary shortint input:
    slot half-window over sqrt(pbs_out^2 + mod_switch^2)."""
    sig = math.sqrt(pbs_out_sigma(p) ** 2 + mod_switch_sigma(p) ** 2)
    return _half_window(msg_bits, carry_bits) / sig


def packed_bivariate_margin_sigma(p: TFHEParams, msg_bits: int = 2,
                                  carry_bits: int = 2,
                                  coarse_bits: int = 0) -> float:
    """PBS decision margin (sigmas) for the PACKED bivariate input
    ct = m_mod * x + y of the radix/shortint multiply layer: the x4 scale
    multiplies the fresh noise, the mod switch adds its floor on top
    (BENCH_LOG "Post-rebalance margins"; scripts/probe_packed_margin.py is
    the exact-integer hardware-free measurement of the same quantity).
    ``coarse_bits = 1`` models re-enabled packed many-LUT — the measured
    infeasibility of round 2 (margin caps at ~5.2-5.8 sigma)."""
    m_mod = 1 << msg_bits
    packed_var = (m_mod ** 2 + 1) * pbs_out_sigma(p) ** 2
    sig = math.sqrt(packed_var + mod_switch_sigma(p, coarse_bits) ** 2)
    return _half_window(msg_bits, carry_bits) / sig
