"""The port's ``mega`` engine (``ops/kernels/megaJ.py``, ``csrc/megaR.cu``)
on the R-major ``bsk_bt``, and its ``mega2`` (``csrc/mega12.cu``'s single
window on ``bsk_btk``), against the JAX package's legacy Pallas kernels on
``bsk_bt``, on the CPU:

- each plain rotation against ``legacy.py::_mega_kernel`` and
  ``_mega2_kernel`` in interpret mode (run as the JAX package's own tests
  run them, once per kernel and set) and against the NumPy reference;
- the key map: ``bsk_btj`` is ``bsk_bt`` with its two block axes swapped;
- a NumPy emulation of ``mega``'s schedule of TMA-staged chunks (chunk f
  -> step, row, block, rows; its ring stage and phase parity; each chunk
  applied to every column tile with the sign flips of a row), held against
  the plain version;
- the wrappers' checks and the gate path on both engines.

Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import port_engine

# HALF = 2 at N = 256 moves the negated run, at k = 1 and k = 2; n is cut
# to 8 steps so that interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
SETS = {"k1": MULTITILE, "k2": MULTITILE_K2}
NAMES = ["mega", "mega2"]
B = 37


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@functools.cache
def keys(params):
    """(client key, server key, JAX key in ``bsk_bt``, port key in
    ``bsk_bt``, ``bsk_btj``, ``mega2``'s ``bsk_btk`` and the ``mega13``
    layout)."""
    ck, sk = jref.keygen(params, np.random.default_rng(31))
    return (ck, sk, jsk.device_server_key(sk, layouts=("bsk_bt",)),
            tsk.device_server_key(sk, layouts=("bsk_btS", "bsk_bt",
                                               "bsk_btj", "bsk_btk"),
                                  device="cpu"))


@functools.cache
def ciphertexts(params):
    return rand_u32(np.random.default_rng(params.k + 43), B, params.n + 1)


@functools.cache
def jax_rotation(name, set_id):
    """The JAX package's ``pallas_<name>`` rotation of ``ciphertexts``, in
    interpret mode: computed once per kernel and set."""
    params = SETS[set_id]
    return np.asarray(jbs.blind_rotate_batch(
        keys(params)[2], jnp.asarray(ciphertexts(params)),
        jbs.make_test_poly(params), engine=f"pallas_{name}", unroll=True))


@functools.cache
def port_rotation(name, set_id):
    params = SETS[set_id]
    tdsk = keys(params)[3]
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ciphertexts(params)),
        tbs.make_test_poly(tdsk.params), engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    return got


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_jax_legacy_pallas(set_id, name):
    np.testing.assert_array_equal(port_rotation(name, set_id),
                                  jax_rotation(name, set_id))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_reference_and_mega13(set_id, name):
    params = SETS[set_id]
    sk, tdsk = keys(params)[1], keys(params)[3]
    ct = ciphertexts(params)
    got = port_rotation(name, set_id)
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(params)))
    np.testing.assert_array_equal(got, to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine="mega13")))


@pytest.mark.parametrize("set_id", list(SETS))
def test_btj_is_bt_with_block_axes_swapped(set_id):
    """``block_toeplitz_layout`` builds ``bsk_btj`` and ``bsk_bt`` from one
    gather and limb order: the j-major key is the R-major one transposed,
    and the port's ``bsk_bt`` is the JAX package's."""
    params = SETS[set_id]
    _, _, jdsk, tdsk = keys(params)
    assert torch.equal(tdsk.bsk_btj, tdsk.bsk_bt.transpose(1, 2))
    np.testing.assert_array_equal(tdsk.bsk_bt.numpy(), np.asarray(jdsk.bsk_bt))
    assert tuple(tdsk.bsk_bt.shape) == megaJ.key_shape(params, "mega")


# --- NumPy emulations of the kernels' arithmetic (csrc/megaR.cu) -----------

def digit_buffer(p, acc, rot):
    """The kernels' digit buffer [R][N/4][G] of 32-bit words, byte u of word
    (r, y4, g) digit r of coefficient 4*y4+u of ciphertext g."""
    G = acc.shape[0]
    x = from_numpy_u32(acc)
    d = poly.negacyclic_monomial_mul(x, torch.as_tensor(rot)[:, None]) - x
    digits = signed_decompose(d, p.bg_bits, p.levels)  # [G, k+1, N, levels]
    d8 = digits.permute(1, 3, 2, 0).reshape(-1, p.N, G).to(torch.int8)
    words = d8.numpy().astype(np.uint8).reshape(-1, p.N // 4, 4, G)
    return (words.astype(np.uint32) << (8 * np.arange(4))[:, None]).sum(
        axis=2).astype(np.uint32)  # [R, N/4, G]


def digit_rows(words):
    """Digit words [..., G] of consecutive coefficients -> int64 digits
    [G, 4 * words] (byte u of a word is its coefficient 4*y4+u)."""
    b = np.asarray(words, dtype=np.uint32).view(np.uint8).reshape(
        *np.shape(words), 4).view(np.int8)  # [y4, G, 4]
    return b.transpose(1, 0, 2).reshape(b.shape[1], -1).astype(np.int64)


def rotation_inputs(p, G, seed):
    """acc [G, k+1, N] u32, rotation amounts [n, G] and a random R-major
    key [n, R, HALF, P, C4P] int8."""
    rng = np.random.default_rng(seed)
    acc = rand_u32(rng, G, p.k + 1, p.N)
    rots = rng.integers(0, 2 * p.N, (p.n, G))
    key = rng.integers(-128, 128, megaJ.key_shape(p, "mega"), dtype=np.int8)
    return acc, rots, key


def plain_rotation(p, acc, rots, key):
    return to_numpy_u32(megaJ.blind_rotate_plain_bt(
        p, from_numpy_u32(acc), torch.as_tensor(rots, dtype=torch.int32),
        torch.as_tensor(key)))


def recombine_into(out, part, ct, P):
    """acc[:, c, ct*P + q] += sum_j part[:, (c, j, q)] << 8j (mod 2^32)."""
    G, C4P = part.shape
    limbs = part.astype(np.uint32).reshape(G, C4P // (4 * P), 4, P)
    total = sum(limbs[:, :, j] << np.uint32(8 * j) for j in range(4))
    out[:, :, ct * P:(ct + 1) * P] += total.astype(np.uint32)


@pytest.mark.parametrize("kc,stages", [(32, 3), (8, 2)])
@pytest.mark.parametrize("k,N", [(1, 512), (2, 256)])
def test_emulated_row_phases_equal_plain(k, N, kc, stages):
    """``mega``'s schedule over two steps, as the producer and consumers
    walk it: chunk f of the rotation is step i, row r, stored block m =
    HALF-1 .. 0 and chunk xc of the block, kc*C4P contiguous bytes of
    ``bsk_bt`` from ((i*R + r)*HALF + m)*P*C4P + xc*kc*C4P, copied into ring
    stage f % stages once the consumers released chunk f - stages; the
    consumers find it there at phase parity (f // stages) & 1 (each stage's
    full barrier completed exactly f // stages + 1 times).  Every chunk is
    applied to every column tile ct against digit chunk (ct - m) mod HALF;
    a row flips the partials of every ct < HALF-1 before block HALF-1 and
    the partial of ct before block ct; one recombine per step.  HALF = 4
    at N = 512 flips three tiles; the ring of 2 stages of 8 rows is the
    least a set may get."""
    p = dc.replace(TOY, n=2, N=N, k=k, bg_bits=7, levels=2)
    G, P = 3, megaJ.P
    acc, rots, key = rotation_inputs(p, G, N + k + kc)
    R, HALF, C4P, PW = (k + 1) * p.levels, N // P, (k + 1) * 4 * P, P // 4
    flat = key.reshape(-1)
    per_block = P // kc
    per_row = HALF * per_block
    per_step = R * per_row
    total = p.n * per_step
    ring = np.zeros((stages, kc, C4P), np.int8)
    fills = np.zeros(stages, int)   # completions of each full barrier
    released = -1                   # the last chunk the consumers released
    produced = 0

    def produce_up_to(f_max):
        nonlocal produced
        while produced < min(f_max, total):
            f = produced
            s = f % stages
            assert f < stages or released >= f - stages  # empty[s] waited
            i, rem = divmod(f, per_step)
            r, rem = divmod(rem, per_row)
            m = HALF - 1 - rem // per_block
            xc = rem % per_block
            src = ((i * R + r) * HALF + m) * P * C4P + xc * kc * C4P
            ring[s] = flat[src:src + kc * C4P].reshape(kc, C4P)
            fills[s] += 1
            produced += 1

    out = acc.copy()
    f = 0
    for i in range(p.n):
        dig = digit_buffer(p, out, rots[i])
        part = np.zeros((HALF, G, C4P), np.int64)
        for r in range(R):
            for m in range(HALF - 1, -1, -1):
                for ct in range(HALF - 1):
                    if m == HALF - 1 or m == ct:
                        part[ct] = -part[ct]
                for xc in range(per_block):
                    produce_up_to(f + stages)  # the producer runs a ring ahead
                    s = f % stages
                    assert fills[s] == f // stages + 1  # the parity it waits on
                    rows = ring[s].astype(np.int64)
                    for ct in range(HALF):
                        sub = (ct - m) & (HALF - 1)
                        y0 = sub * PW + xc * (kc // 4)
                        part[ct] += digit_rows(dig[r, y0:y0 + kc // 4]) @ rows
                    released = f
                    f += 1
        for ct in range(HALF):
            recombine_into(out, part[ct], ct, P)
    assert f == total == produced
    np.testing.assert_array_equal(out, plain_rotation(p, acc, rots, key))


# --- the wrappers, the gate path and the engine names ----------------------

@pytest.mark.parametrize("name", NAMES)
def test_megaR_wrapper_checks(name):
    """Each wrapper's argument checks; ``mega`` reads ``bsk_bt`` and its
    plain version ``blind_rotate_plain_bt``, ``mega2`` (``csrc/mega12.cu``)
    ``bsk_btk`` and ``mega12.blind_rotate_plain_btk``."""
    _, _, _, tdsk = keys(MULTITILE_K2)
    p = tdsk.params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    key = getattr(tdsk, megaJ.KEY_LAYOUTS[name])
    with pytest.raises(TypeError):
        kernel(p, acc, a_t.long(), key)
    with pytest.raises(TypeError):
        kernel(p, acc, a_t, key.to(torch.int32))
    with pytest.raises(ValueError):
        kernel(p, acc, a_t[:, :1].contiguous(), key)
    # the other kernel's key: bsk_btj (bsk_bt's block axes swapped) for
    # mega, the JAX package's bsk_bt for mega2
    with pytest.raises(ValueError):
        kernel(p, acc, a_t, tdsk.bsk_btj if name == "mega" else tdsk.bsk_bt)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(p, acc, a_t, key.transpose(-1, -2).contiguous().transpose(
            -1, -2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel(p, acc.to("meta"), a_t.to("meta"), key.to("meta"))
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3),
                dc.replace(p, N=4096)):
        with pytest.raises(ValueError):
            megaJ.check_params(bad, name)
    for pset in ("std128_k2", "std128", "std128_fast", "std128_shortint",
                 "std128_k4", "std128_shortint_l4"):
        megaJ.check_params(PARAM_SETS[pset], name)
    layout = {"mega": "bsk_bt", "mega2": "bsk_btk"}[name]
    assert tsk.layouts_for_engine(name) == (layout,)
    assert tbs.ROTATION_ENGINES[name] == (kernel, layout)
    assert megaJ.plain(name) is {
        "mega": megaJ.blind_rotate_plain_bt,
        "mega2": mega12.blind_rotate_plain_btk}[name]
    assert (name in megaJ.ROW_SOURCE) == (name == "mega")
    assert (name in megaJ.TENSOR_CORE) == (name == "mega2")
    assert port_engine(f"pallas_{name}") == name


def test_check_params_names_the_ring():
    """A set whose ciphertext nearly fills a dp4a block of one is taken by
    ``mega7`` and ``mega2`` (``csrc/mega12.cu``: digits and accumulators in
    device memory), but not by ``mega``'s smallest ring beside one: two
    stages of 8 K rows."""
    wide = dc.replace(PARAM_SETS["std128_shortint"], name="wide", k=4,
                      bg_bits=2, levels=16)
    megaJ.check_params(wide, "mega7")
    megaJ.check_params(wide, "mega2")
    with pytest.raises(ValueError, match="shared memory"):
        megaJ.check_params(wide, "mega")
    assert megaJ.ring_bytes(wide) == 2 * 8 * 5 * 4 * 128 + 32


@pytest.mark.parametrize("name", NAMES)
def test_gate_batch_on_mega_engines(name):
    """``gate_batch`` on each engine decrypts to the truth table and equals
    ``bt_fused``'s and ``mega13``'s outputs on the same key."""
    ck, _, _, tdsk = keys(MULTITILE_K2)
    rng = np.random.default_rng(47)
    n_gates = 12
    b1, b2 = (rng.integers(0, 2, n_gates).astype(bool) for _ in range(2))
    ids = np.arange(n_gates) % len(tgates.GATE_IDS)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    batch = tgates.GateBatch(ids, c1, c2)
    got = to_numpy_u32(tgates.gate_batch(tdsk, batch, engine=name,
                                         device="cpu"))
    for other in ("bt_fused", "mega13"):
        np.testing.assert_array_equal(got, to_numpy_u32(tgates.gate_batch(
            tdsk, batch, engine=other, device="cpu")))
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    names = list(tgates.GATE_IDS)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        [truth[names[g]][i] for i, g in enumerate(ids)])
