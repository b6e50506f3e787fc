"""The port's gates and the slice as a whole (levelized circuit evaluation)
against the JAX package on the CPU: heterogeneous ``gate_batch``,
``mux_batch`` and ``compile_circuit`` on a 4-bit adder, each array-equal to
the JAX package's ``gather_u32`` engine on the same key and ciphertexts, and
decrypting to the plaintext truth.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest

from herdsman_tpu.circuit import CircuitBuilder as JCircuitBuilder
from herdsman_tpu.circuit import ColumnMeta as JColumnMeta
from herdsman_tpu.circuit import DataType as JDataType
from herdsman_tpu.compiler import lower as jlower
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import gates as jgates
from herdsman_tpu.ops.server_key import device_server_key as jax_dsk
from herdsman_tpu_torch.circuit import CircuitBuilder, ColumnMeta, DataType
from herdsman_tpu_torch.compiler import lower as tlower
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops.server_key import device_server_key
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

B8L2_K1 = dc.replace(TOY, name="toy_b8l2_k1", n=8, N=256, k=1, bg_bits=8,
                     levels=2)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(42)
    ck, sk = jref.keygen(TOY, rng)
    return ck, rng, jax_dsk(sk, layouts=("bsk_ext",)), \
        device_server_key(sk, device="cpu")


def test_gate_tables_equal_jax():
    assert tgates.GATE_COEFFS == jgates.GATE_COEFFS
    assert tgates.GATE_IDS == jgates.GATE_IDS


def test_gate_batch_heterogeneous_equals_jax(toy):
    ck, rng, jdsk, dsk = toy
    names = list(tgates.GATE_IDS) * 4                  # every kind, 24 gates
    b1 = rng.integers(0, 2, len(names)).astype(bool)
    b2 = rng.integers(0, 2, len(names)).astype(bool)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    ids = np.array([tgates.GATE_IDS[g] for g in names], dtype=np.int32)
    got = to_numpy_u32(tgates.gate_batch(
        dsk, tgates.GateBatch(ids, c1, c2), device="cpu"))
    want = np.asarray(jgates.gate_batch(
        jdsk, jgates.GateBatch(jnp.asarray(ids), jnp.asarray(c1),
                               jnp.asarray(c2)), engine="gather_u32"))
    np.testing.assert_array_equal(got, want)
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    expect = np.array([truth[g][i] for i, g in enumerate(names)])
    np.testing.assert_array_equal(jref.lwe_decrypt_bool(ck, got), expect)


def test_mux_batch_equals_jax(toy):
    ck, rng, jdsk, dsk = toy
    combos = [(s, a, b) for s in (0, 1) for a in (0, 1) for b in (0, 1)]
    sel, ca, cb = (jref.encrypt_bool(ck, np.array([c[i] for c in combos],
                                                  bool), rng)
                   for i in range(3))
    got = to_numpy_u32(tgates.mux_batch(dsk, sel, ca, cb, device="cpu"))
    want = np.asarray(jgates.mux_batch(jdsk, jnp.asarray(sel),
                                       jnp.asarray(ca), jnp.asarray(cb),
                                       engine="gather_u32"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        np.array([a if s else b for (s, a, b) in combos], dtype=bool))


def test_gate_not(toy):
    ck, rng, _, _ = toy
    bits = np.array([True, False])
    ct = jref.encrypt_bool(ck, bits, rng)
    got = to_numpy_u32(tgates.gate_not(from_numpy_u32(ct)))
    np.testing.assert_array_equal(got, np.asarray(jgates.gate_not(
        jnp.asarray(ct))))
    np.testing.assert_array_equal(jref.lwe_decrypt_bool(ck, got), ~bits)


def _adder4(builder, column, dtype):
    """(a + b) mod 16 on the low nibbles (a ripple-carry chain), and a MUX
    level beside it: a[0] ? b : a."""
    cb = builder((column("a", dtype.UINT8), column("b", dtype.UINT8)))
    a, b = cb.input_column("a"), cb.input_column("b")
    low = type(a)
    s = low(a.bits[:4]) + low(b.bits[:4])
    cb.output("s", low(s.bits + (cb.const(False),) * 4))
    cb.output("m", b.mux(a.bits[0], a))
    return cb.build()


def test_compile_circuit_adder_equals_jax_and_plain():
    """The slice: a levelized 4-bit adder at a B8L2 toy set, through the
    port's compile_circuit (kernel module on CPU = the plain version) and
    the JAX package's, on the same key and encrypted rows."""
    jcirc = _adder4(JCircuitBuilder, JColumnMeta, JDataType)
    tcirc = _adder4(CircuitBuilder, ColumnMeta, DataType)
    assert repr(tcirc.gates) == repr(jcirc.gates)
    assert tlower.circuit_cost(tcirc) == jlower.circuit_cost(jcirc)
    assert [(lv.bootstrap_gates, lv.mux_gates)
            for lv in tlower.levelize(tcirc)[0]] == [
        (lv.bootstrap_gates, lv.mux_gates) for lv in jlower.levelize(jcirc)[0]]

    rng = np.random.default_rng(2)
    ck, sk = jref.keygen(B8L2_K1, rng)
    rows = [(3, 5), (200, 100), (15, 1), (255, 255)]
    bits = np.array([[(v >> i) & 1 for v in r for i in range(8)]
                     for r in rows], dtype=bool)
    x = jref.encrypt_bool(ck, bits, rng)              # [rows, 16, n+1]
    run = tlower.compile_circuit(tcirc, device_server_key(sk, device="cpu"),
                                 device="cpu")
    got = to_numpy_u32(run(x))
    want = np.asarray(jlower.compile_circuit(
        jcirc, jax_dsk(sk, layouts=("bsk_ext",)), engine="gather_u32")(
            jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    dec = jref.lwe_decrypt_bool(ck, got)               # [rows, 16]
    plain = tlower.evaluate_plain(tcirc, rows)
    assert plain == jlower.evaluate_plain(jcirc, rows)
    for r, (a, b) in enumerate(rows):
        vals = [sum(int(bt) << i for i, bt in enumerate(dec[r, 8 * c:8 * c + 8]))
                for c in range(2)]
        assert vals == [plain[r]["s"], plain[r]["m"]]
        assert vals == [((a & 15) + (b & 15)) & 15, b if a & 1 else a]
