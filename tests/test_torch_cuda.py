"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version (array equality: the arithmetic is exact mod 2^32), and the
blind rotation of every engine against the NumPy reference.

They need an NVIDIA Hopper card, ``nvcc`` and the repo's sources, and skip
without a card.  This file imports neither ``jax`` nor ``herdsman_tpu``, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -s tests/test_torch_cuda.py
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import gates
from herdsman_tpu_torch.ops.kernels import (_build, bt, mega12, mega13,
                                            megaJ, megaS, megaT)
from herdsman_tpu_torch.ops.kernels import rotate_decompose as rd
from herdsman_tpu_torch.ops.server_key import bt_tile, device_server_key
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

pytestmark = pytest.mark.cuda

# every kernel geometry class: the three B8L2 sets of the JAX tests (the
# last is the STD128_K2 tile geometry), the TOY gadget (bg=2^6, l=3), k=4,
# the exact W=32 gadget, and N=1024 / N=2048 (2 and 4 outputs per thread)
KERNEL_SETS = [
    dc.replace(TOY, name="toy_b8l2_k1", n=8, N=256, k=1, bg_bits=8, levels=2),
    dc.replace(TOY, name="toy_b8l2_k2", n=8, N=256, k=2, bg_bits=8, levels=2),
    dc.replace(TOY, name="toy_b8l2_k2_n512", n=8, N=512, k=2, bg_bits=8,
               levels=2),
    TOY,
    dc.replace(TOY, name="toy_k4", n=8, N=256, k=4, bg_bits=8, levels=2),
    dc.replace(TOY, name="toy_b8l4", n=8, N=256, k=1, bg_bits=8, levels=4),
    dc.replace(TOY, name="toy_n1024", n=4, N=1024, k=1, bg_bits=7, levels=3),
    dc.replace(TOY, name="toy_n2048", n=4, N=2048, k=1, bg_bits=7, levels=3),
]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def test_kernels_build(card):
    for name, (secs, log) in _build.build().items():
        print(f"built {name} in {secs:.1f} s\n{log}")
    for name in _build.sources():
        assert _build.load(name) is not None


@pytest.mark.parametrize("params", KERNEL_SETS, ids=[q.name for q in KERNEL_SETS])
def test_mega13_matches_plain_and_reference(card, params):
    rng = np.random.default_rng(5)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, device=card)
    cpu_key = device_server_key(sk, device="cpu").bsk_btS
    assert torch.equal(dsk.bsk_btS.cpu(), cpu_key)  # built on the card
    B = 20  # a ragged tile of the kernel's 128 ciphertexts
    ct = rand_u32(rng, B, params.n + 1)
    tp = bs.make_test_poly(params, device=card)
    before = mega13.mega13_blind_rotate.launches
    got = bs.blind_rotate_batch(dsk, from_numpy_u32(ct, card), tp)
    torch.cuda.synchronize()
    assert mega13.mega13_blind_rotate.launches == before + 1
    acc0, a_t = bs.rotation_inputs(params, from_numpy_u32(ct, card), tp)
    plain = mega13.blind_rotate_plain_btS(params, acc0, a_t, dsk.bsk_btS)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(plain))
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            to_numpy_u32(got[i]),
            ref.blind_rotate(sk, ct[i], ref.make_test_poly(params)))


def test_gate_batch_on_card(card):
    params = KERNEL_SETS[2]
    rng = np.random.default_rng(6)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, device=card)
    b1 = rng.integers(0, 2, 48).astype(bool)
    b2 = rng.integers(0, 2, 48).astype(bool)
    ids = np.arange(48) % len(gates.GATE_IDS)
    c1, c2 = ref.encrypt_bool(ck, b1, rng), ref.encrypt_bool(ck, b2, rng)
    out = to_numpy_u32(gates.gate_batch(dsk, gates.GateBatch(ids, c1, c2),
                                        device=card))
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    expect = np.array([truth[g][i] for i, g in
                       enumerate(np.array(list(gates.GATE_IDS))[ids])])
    np.testing.assert_array_equal(ref.lwe_decrypt_bool(ck, out), expect)
    lin0 = gates.gate_linear(params.n, torch.as_tensor(ids[:1]),
                             from_numpy_u32(c1[:1]), from_numpy_u32(c2[:1]))
    np.testing.assert_array_equal(
        out[0], ref.bootstrap_bool(sk, to_numpy_u32(lin0)[0]))


# the block-Toeplitz kernels' geometry classes: k+1 in (2, 3, 5), N from
# 32 to 2048 (P = 32 and 64 with one column tile, then P = 128 and HALF 2
# to 16), the two gadgets (2^8, 2) and (2^7, 3)
BT_SETS = [
    dc.replace(TOY, name="bt_k1_n32_b6l3", n=4, N=32, k=1),
    dc.replace(TOY, name="bt_k2_n64_b8l2", n=4, N=64, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="bt_k1_n256_b8l2", n=4, N=256, k=1, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="bt_k2_n512_b8l2", n=4, N=512, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="bt_k4_n256_b7l3", n=4, N=256, k=4, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="bt_k1_n1024_b7l3", n=4, N=1024, k=1, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="bt_k2_n2048_b8l2", n=4, N=2048, k=2, bg_bits=8,
               levels=2),
]


# every plan of the H100 (bt.plan): 64-row tiles split over K (1, 9, 63,
# 64, 65), 64-row tiles whole (129, 288), 128-row tiles (2048, 16384),
# ragged last tiles beside full ones
@pytest.mark.parametrize("B", [1, 9, 63, 64, 65, 129, 288, 2048, 16384])
@pytest.mark.parametrize("params", BT_SETS, ids=[q.name for q in BT_SETS])
def test_bt_kernels_match_plain(card, params, B):
    p = params
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    rng = np.random.default_rng(B + p.N + p.k)
    acc = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_i = torch.as_tensor(rng.integers(0, 2 * p.N, B), dtype=torch.int32,
                          device=card)
    before = rd.rotate_decompose.launches
    d8 = rd.rotate_decompose(p, acc, a_i)
    assert rd.rotate_decompose.launches == before + 1
    assert torch.equal(d8, rd.rotate_decompose_plain(p, acc, a_i))
    key = torch.as_tensor(rng.integers(-128, 128, (R, HALF, P,
                                                   (p.k + 1) * 4 * P)),
                          dtype=torch.int8, device=card)
    for glwe in (None, acc):
        before = bt.external_product_bt.launches
        got = bt.external_product_bt(p, d8, key, glwe=glwe)
        torch.cuda.synchronize()
        assert bt.external_product_bt.launches == before + 1
        assert torch.equal(got, bt.external_product_bt_plain(p, d8, key,
                                                             glwe=glwe))


@pytest.mark.parametrize("params", BT_SETS, ids=[q.name for q in BT_SETS])
def test_bt_kernel_plan_matches_python(card, params):
    """The built kernel's own ``bt_plan`` equals ``bt.plan`` on this card and
    on others' SM counts."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for n_sms in (sms, 8, 132, 2048):
        for B in (1, 9, 63, 64, 65, 129, 288, 2048, 16384):
            assert bt.kernel_plan(params, B, n_sms) == \
                bt.plan(params, B, n_sms)[:2], (B, n_sms)


@pytest.mark.parametrize("params", BT_SETS[2:5], ids=[q.name for q in
                                                      BT_SETS[2:5]])
def test_bt_engines_match_mega13_and_reference(card, params):
    rng = np.random.default_rng(9)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, layouts=("bsk_btS", "bsk_bt"), device=card)
    cpu_bt = device_server_key(sk, layouts=("bsk_bt",), device="cpu").bsk_bt
    assert torch.equal(dsk.bsk_bt.cpu(), cpu_bt)  # built on the card
    B = 13
    ct = from_numpy_u32(rand_u32(rng, B, params.n + 1), card)
    tp = bs.make_test_poly(params, device=card)
    want = bs.blind_rotate_batch(dsk, ct, tp, engine="mega13")
    for engine in ("bt", "bt_fused"):
        got = bs.blind_rotate_batch(dsk, ct, tp, engine=engine)
        assert torch.equal(got, want), engine
    np.testing.assert_array_equal(
        to_numpy_u32(want[0]),
        ref.blind_rotate(sk, to_numpy_u32(ct[0]), ref.make_test_poly(params)))


# mega12's geometry classes: k+1 in (2, 3) (and 5), N from 256 to 2048
# (HALF 2 to 16), the two gadgets (2^8, 2) and (2^7, 3); B = 129 takes a
# ragged M tile
MEGA12_SETS = [
    dc.replace(TOY, name="m12_k1_n256_b8l2", n=4, N=256, k=1, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="m12_k2_n256_b7l3", n=4, N=256, k=2, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="m12_k1_n1024_b7l3", n=4, N=1024, k=1, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="m12_k2_n1024_b8l2", n=4, N=1024, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="m12_k1_n2048_b7l3", n=4, N=2048, k=1, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="m12_k2_n2048_b8l2", n=4, N=2048, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="m12_k4_n256_b8l2", n=4, N=256, k=4, bg_bits=8,
               levels=2),
]
# the tensor-core mega12 also at STD128_SHORTINT_L4's gadget (W = 32)
MEGA12_TC_SETS = [*MEGA12_SETS, dc.replace(
    TOY, name="m12_k1_n2048_b8l4", n=4, N=2048, k=1, bg_bits=8, levels=4)]


# every plan of mega12.plan on the H100 at N = 2048: 64-row tiles split 2
# ways (B = 1, 9), 64-row tiles (65), 128-row tiles in two-block clusters
# in one wave (129, 256), with a lone M tile beside pad rows (384) and in
# 7.8 waves (2048)
@pytest.mark.parametrize("B", [1, 9, 129, 65, 256, 2048, 384])
@pytest.mark.parametrize("params", MEGA12_TC_SETS,
                         ids=[q.name for q in MEGA12_TC_SETS])
def test_mega12_matches_plain(card, params, B):
    p = params
    rng = np.random.default_rng(B + p.N + p.k)
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(rng.integers(-128, 128, mega12.key_shape(p)),
                          dtype=torch.int8, device=card)
    before = mega12.mega12_blind_rotate.launches
    got = mega12.mega12_blind_rotate(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert mega12.mega12_blind_rotate.launches == before + 1
    assert torch.equal(got, mega12.blind_rotate_plain_btk(p, acc0, a_t, key))
    # again on the same inputs: the barrier count starts anew each launch
    assert torch.equal(mega12.mega12_blind_rotate(p, acc0, a_t, key), got)


# csrc/mega12.cu's wrappers, at every plan and geometry class of mega12's:
# mega11, mega10, mega8 and mega9 (the doubled window on bsk_btk2) and
# mega7, mega5, mega4, mega6, mega3, mega2 and mega (the single window),
# each counted apart
@pytest.mark.parametrize("B", [1, 9, 129, 65, 256, 2048, 384])
@pytest.mark.parametrize("params", MEGA12_TC_SETS,
                         ids=[q.name for q in MEGA12_TC_SETS])
@pytest.mark.parametrize("name", list(megaJ.KERNELS))
def test_mega12_windows_match_plain(card, name, params, B):
    p = params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + p.N + p.k + len(name))
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(rng.integers(-128, 128, megaJ.key_shape(p, name)),
                          dtype=torch.int8, device=card)
    before = (kernel.launches, mega12.mega12_blind_rotate.launches)
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert (kernel.launches, mega12.mega12_blind_rotate.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, megaJ.plain(name)(p, acc0, a_t, key))
    assert torch.equal(kernel(p, acc0, a_t, key), got)
    if not megaJ.KERNELS[name]:  # the single window: mega12's launch
        assert torch.equal(mega12.mega12_blind_rotate(p, acc0, a_t, key), got)


def test_mega12_kernel_plan_matches_python(card):
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    for p in [*MEGA12_TC_SETS, PARAM_SETS["std128_shortint"]]:
        for B in (1, 9, 65, 129, 256, 2048, 16384):
            pl = mega12.plan(p, B, n_sms)
            assert mega12.kernel_plan(p, B, n_sms) == (pl.bm, pl.splits,
                                                        pl.cluster)


@pytest.mark.parametrize("params", MEGA12_SETS[:2],
                         ids=[q.name for q in MEGA12_SETS[:2]])
def test_mega12_engine_matches_mega13_and_reference(card, params):
    rng = np.random.default_rng(10)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, layouts=("bsk_btS", "bsk_btk"), device=card)
    cpu_k = device_server_key(sk, layouts=("bsk_btk",), device="cpu").bsk_btk
    assert torch.equal(dsk.bsk_btk.cpu(), cpu_k)  # built on the card
    B = 13
    ct = from_numpy_u32(rand_u32(rng, B, params.n + 1), card)
    tp = bs.make_test_poly(params, device=card)
    got = bs.blind_rotate_batch(dsk, ct, tp, engine="mega12")
    assert torch.equal(got, bs.blind_rotate_batch(dsk, ct, tp,
                                                  engine="mega13"))
    np.testing.assert_array_equal(
        to_numpy_u32(got[B - 1]),
        ref.blind_rotate(sk, to_numpy_u32(ct[B - 1]),
                         ref.make_test_poly(params)))


# the byte-aligned kernels' geometry classes (mega16 / mega17 / mega15 at
# levels 2 / 3 / 4, mega14 at levels 2 on the extended key), all of
# csrc/megaS.cu: k+1 in (2, 3, 5), N from 256 to 2048 (HALF 2 to 16); B =
# 129 and 2001 take ragged tiles, B = 1 and 9 split K
MEGAT_GEOMETRIES = [(1, 256), (2, 512), (4, 256), (1, 1024), (1, 2048),
                    (2, 2048)]
MEGAT_SETS = [dc.replace(TOY, name=f"{name}_k{k}_n{N}", n=4, N=N, k=k,
                         bg_bits=8, levels=L)
              for name, L in megaT.KERNELS.items()
              for k, N in MEGAT_GEOMETRIES]


@pytest.mark.parametrize("B", [1, 9, 129, 2001])
@pytest.mark.parametrize("params", MEGAT_SETS,
                         ids=[q.name for q in MEGAT_SETS])
def test_megaT_matches_plain(card, params, B):
    p = params
    name = p.name.split("_")[0]
    extended = name in megaT.EXTENDED
    kernel = getattr(megaT, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + p.N + p.k + p.levels)
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(
        rng.integers(-128, 128, (p.n, p.k + 1, p.k + 1, 4,
                                 megaT.row_bytes(p, extended))),
        dtype=torch.int8, device=card)
    before = kernel.launches
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if not extended:  # mega16, mega17, mega15: mega13's kernel
        n_sms = torch.cuda.get_device_properties(card).multi_processor_count
        pl = megaS.plan(p, B, n_sms=n_sms)
        assert megaS.kernel_plan(p, B, name, n_sms) == (pl.units, pl.splits)
    assert torch.equal(got, megaT.plain(name)(p, acc0, a_t, key))


@pytest.mark.parametrize("name", sorted(megaT.KERNELS))
def test_megaT_engines_match_mega12_and_reference(card, name):
    params = dc.replace(TOY, name=f"{name}_k1_n512", n=8, N=512, k=1,
                        bg_bits=8, levels=megaT.KERNELS[name])
    layout = megaT.KEY_LAYOUTS[name]
    rng = np.random.default_rng(12)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, layouts=("bsk_btk", layout), device=card)
    cpu_key = getattr(device_server_key(sk, layouts=(layout,), device="cpu"),
                      layout)
    assert torch.equal(getattr(dsk, layout).cpu(), cpu_key)  # built on card
    B = 37
    ct = from_numpy_u32(rand_u32(rng, B, params.n + 1), card)
    tp = bs.make_test_poly(params, device=card)
    got = bs.blind_rotate_batch(dsk, ct, tp, engine=name)
    assert torch.equal(got, bs.blind_rotate_batch(dsk, ct, tp,
                                                  engine="mega12"))
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            to_numpy_u32(got[i]),
            ref.blind_rotate(sk, to_numpy_u32(ct[i]),
                             ref.make_test_poly(params)))


# the j-major family (every wrapper of mega12.cu's two windows) at
# mega12's geometry classes, tiled as mega12 tiles; B = 129 takes a ragged
# M tile
@pytest.mark.parametrize("B", [1, 9, 129])
@pytest.mark.parametrize("name", sorted(megaJ.KERNELS))
@pytest.mark.parametrize("params", MEGA12_SETS,
                         ids=[q.name for q in MEGA12_SETS])
def test_megaJ_matches_plain(card, params, name, B):
    p = params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + p.N + p.k + len(name))
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(
        rng.integers(-128, 128, megaJ.key_shape(p, name)),
        dtype=torch.int8, device=card)
    before = kernel.launches
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert mega12.kernel_plan(p, B, n_sms) == tuple(
        mega12.plan(p, B, n_sms))[:3]
    assert torch.equal(got, megaJ.plain(name)(p, acc0, a_t, key))


@pytest.mark.parametrize("name", sorted(megaJ.KERNELS))
@pytest.mark.parametrize("params", MEGA12_SETS[:2],
                         ids=[q.name for q in MEGA12_SETS[:2]])
def test_megaJ_engines_match_mega13_and_reference(card, params, name):
    layout = megaJ.KEY_LAYOUTS[name]
    rng = np.random.default_rng(13)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, layouts=("bsk_btS", layout), device=card)
    cpu_key = getattr(device_server_key(sk, layouts=(layout,), device="cpu"),
                      layout)
    assert torch.equal(getattr(dsk, layout).cpu(), cpu_key)  # built on card
    B = 13
    ct = from_numpy_u32(rand_u32(rng, B, params.n + 1), card)
    tp = bs.make_test_poly(params, device=card)
    got = bs.blind_rotate_batch(dsk, ct, tp, engine=name)
    assert torch.equal(got, bs.blind_rotate_batch(dsk, ct, tp,
                                                  engine="mega13"))
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            to_numpy_u32(got[i]),
            ref.blind_rotate(sk, to_numpy_u32(ct[i]),
                             ref.make_test_poly(params)))


# mega14 at the widths of the smoke run's paths (B = 2048 fills the card),
# n cut to 4 steps (test_mega12_windows_match_plain holds mega9 at B =
# 2048)
WIDE_SETS = [
    dc.replace(TOY, name="mega14_k2_n512", n=4, N=512, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="mega14_k4_n256", n=4, N=256, k=4, bg_bits=8,
               levels=2),
]


@pytest.mark.parametrize("params", WIDE_SETS, ids=[q.name for q in WIDE_SETS])
def test_new_kernels_match_plain_at_width(card, params):
    p = params
    name = p.name.split("_")[0]
    kernel = getattr(megaT, f"{name}_blind_rotate")
    B = 2048
    rng = np.random.default_rng(p.N + p.k)
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    shape = (p.n, p.k + 1, p.k + 1, 4, megaT.row_bytes(p, True))
    key = torch.as_tensor(rng.integers(-128, 128, shape), dtype=torch.int8,
                          device=card)
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert torch.equal(got, megaT.plain(name)(p, acc0, a_t, key))


# the geometries of STD128_K2, STD128 and STD128_SHORTINT (n cut to 2
# steps)
LEGACY_J_SETS = [dc.replace(PARAM_SETS[name], n=2)
                 for name in ("std128_k2", "std128", "std128_shortint")]


# csrc/mega12.cu's single window under the wrappers of the JAX package's
# legacy mega5, mega4, mega6, mega3, mega2 and mega, on one random bsk_btk
# at LEGACY_J_SETS' geometries, at the smoke run's widths (B = 2048 fills
# the card) and a ragged 37: each equals the plain version and mega7 on the
# same key, each launch counted on its own wrapper only
@pytest.mark.parametrize("B", [2048, 256, 37, 9])
@pytest.mark.parametrize("params", LEGACY_J_SETS,
                         ids=[q.name for q in LEGACY_J_SETS])
def test_single_window_wrappers_match_plain_and_mega7(card, params, B):
    p = params
    gen = torch.Generator(device=card)
    gen.manual_seed(B + p.N + p.k)
    acc0 = torch.randint(-2**31, 2**31, (B, p.k + 1, p.N), dtype=torch.int32,
                         device=card, generator=gen)
    a_t = torch.randint(0, 2 * p.N, (p.n, B), dtype=torch.int32, device=card,
                        generator=gen)
    key = torch.randint(-128, 128, mega12.key_shape(p), dtype=torch.int8,
                        device=card, generator=gen)
    want = mega12.blind_rotate_plain_btk(p, acc0, a_t, key)
    names = ("mega7", "mega5", "mega4", "mega6", "mega3", "mega2", "mega")
    wrappers = {name: getattr(megaJ, f"{name}_blind_rotate")
                for name in names}
    wrappers["mega12"] = mega12.mega12_blind_rotate
    for name in names:
        before = {k: fn.launches for k, fn in wrappers.items()}
        got = wrappers[name](p, acc0, a_t, key)
        torch.cuda.synchronize()
        assert {k: fn.launches - before[k] for k, fn in wrappers.items()} \
            == {k: int(k == name) for k in wrappers}
        assert torch.equal(got, want), name


# csrc/megaS.cu: mega13 on bsk_btS at every geometry class it takes (the
# tile N below 128, a padded stream at TOY and N = 32, the W = 32 gadget,
# k+1 = 3 and 5, N up to 2048) and mega14 on bsk_btTe, random keys, n cut
# to 4 steps, at widths of one ragged tile up to the smoke run's 2048
MEGAS_SETS = [dc.replace(TOY, name=f"mega13_{q}", n=4, N=N, k=k, bg_bits=bg,
                         levels=L)
              for q, N, k, bg, L in (("n32_b8l1", 32, 1, 8, 1),
                                     ("toy", 64, 1, 6, 3),
                                     ("n128_b8l4", 128, 1, 8, 4),
                                     ("k2_n512", 512, 2, 8, 2),
                                     ("k4_n256", 256, 4, 8, 2),
                                     ("n1024_b7l3", 1024, 1, 7, 3),
                                     ("n2048_b7l3", 2048, 1, 7, 3))]
MEGAS_SETS += [dc.replace(TOY, name=f"mega14_k{k}_n{N}", n=4, N=N, k=k,
                          bg_bits=8, levels=2)
               for k, N in ((2, 512), (4, 256), (1, 2048))]


def test_megaS_geometry_matches_python(card):
    for N in (32, 64, 128, 256, 512, 1024, 2048):
        for L in (1, 2, 3, 4):
            assert megaS.kernel_geometry(N, L, False) == \
                megaS.geometry(N, L, False)
            if N >= 256:
                assert megaS.kernel_geometry(N, L, True) == \
                    megaS.geometry(N, L, True)


@pytest.mark.parametrize("B", [1, 9, 128, 129, 256, 2048])
@pytest.mark.parametrize("params", MEGAS_SETS,
                         ids=[q.name for q in MEGAS_SETS])
def test_megaS_matches_plain(card, params, B):
    p = params
    name = p.name.split("_")[0]
    extended = megaS.KERNELS[name]
    kernel = (mega13.mega13_blind_rotate if name == "mega13"
              else megaT.mega14_blind_rotate)
    plain = (mega13.blind_rotate_plain_btS if name == "mega13"
             else megaT.blind_rotate_plain_btTe)
    rng = np.random.default_rng(B + p.N + p.k + p.levels)
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(rng.integers(-128, 128,
                                       megaS.key_shape(p, extended)),
                          dtype=torch.int8, device=card)
    before = kernel.launches
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, plain(p, acc0, a_t, key))


# mega17, mega15 and mega16 (csrc/megaS.cu's kernel through their own C
# entries, on bsk_btTc) at the N = 2048 sets' geometries, n cut to 8 steps:
# a full batch, a ragged one, the widths of paths E's, G's and F's reruns, a
# K split, one ciphertext; and each against mega13's entry on the same key
# bytes
B8_SETS = [dc.replace(PARAM_SETS[s], n=8)
           for s in ("std128_shortint_b8", "std128_shortint_l4",
                     "std128_shortint_fast")]


@pytest.mark.parametrize("B", [2048, 300, 256, 9, 1])
@pytest.mark.parametrize("params", B8_SETS, ids=[q.name for q in B8_SETS])
def test_megaS_b8_matches_plain_and_mega13(card, params, B):
    p = params
    name = {3: "mega17", 4: "mega15", 2: "mega16"}[p.levels]
    kernel = getattr(megaT, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + p.levels)
    acc0 = from_numpy_u32(rand_u32(rng, B, p.k + 1, p.N), card)
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, B)),
                          dtype=torch.int32, device=card)
    key = torch.as_tensor(rng.integers(-128, 128, megaS.key_shape(p)),
                          dtype=torch.int8, device=card)
    before = kernel.launches
    got = kernel(p, acc0, a_t, key)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, megaT.blind_rotate_plain_btTc(p, acc0, a_t, key))
    assert torch.equal(got, megaS.launch("mega13", p, acc0, a_t, key))


def test_megaS_plan_matches_python(card):
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    for p in [*B8_SETS, *MEGAS_SETS]:
        for name, extended in megaS.KERNELS.items():
            if extended != (p.name.startswith("mega14")):
                continue
            for B in (1, 9, 130, 256, 300, 2048):
                pl = megaS.plan(p, B, extended, n_sms)
                assert megaS.kernel_plan(p, B, name, n_sms) == (
                    pl.units, pl.splits), (name, p.name, B)


# the NTT/RNS path (ops/ntt, ops/rns): no hand-written kernel, but its DFT
# steps' torch._int_mm on the card wants K and the columns multiples of 8
# and more than 16 rows (N = 16 and 32 pad K from 4 to 8, N = 16 the
# columns from 12 to 16; a [1, N] row pads the rows to 32)
@pytest.mark.parametrize("N", [16, 32, 64, 128, 256, 2048, 4096])
def test_ntt_on_card_equals_cpu(card, N):
    from herdsman_tpu_torch.ops import rns

    gpu, cpu = rns.make_rns(N, 3, device=card), rns.make_rns(N, 3,
                                                             device="cpu")
    rng = np.random.default_rng(N)
    for shape in ((1,), (5, 7)):
        a, b = (np.stack([rng.integers(0, p, shape + (N,)).astype(np.uint32)
                          for p in cpu.primes]) for _ in range(2))
        spec = rns.ntt_fwd(gpu, a)
        assert torch.equal(spec.cpu(), rns.ntt_fwd(cpu, a))
        assert torch.equal(rns.ntt_inv(gpu, spec).cpu(),
                           torch.from_numpy(a.view(np.int32)))
        assert torch.equal(rns.polymul(gpu, a, b).cpu(),
                           rns.polymul(cpu, a, b))


def test_rns_key_switch_on_card_equals_cpu(card):
    from herdsman_tpu_torch.ops import rns

    N = 256
    gpu, cpu = rns.make_rns(N, 3, device=card), rns.make_rns(N, 3,
                                                             device="cpu")
    rng = np.random.default_rng(1)
    s1, s2 = rng.integers(0, 2, N), rng.integers(0, 2, N)
    kg = rns.keyswitch_keygen(gpu, s1, s2, np.random.default_rng(2))
    kc = rns.keyswitch_keygen(cpu, s1, s2, np.random.default_rng(2))
    assert kg.ksk_a.device == card
    assert torch.equal(kg.ksk_a.cpu(), kc.ksk_a)
    assert torch.equal(kg.ksk_b.cpu(), kc.ksk_b)
    ct = np.stack([np.stack([rng.integers(0, p, (9, N)).astype(np.uint32)
                             for p in cpu.primes]) for _ in range(2)])
    for x in (ct, ct[:, :, 0].copy()):
        assert torch.equal(rns.key_switch(gpu, kg, x).cpu(),
                           rns.key_switch(cpu, kc, x))


# the mesh (mesh/sharding, mesh/ntt_sharded) with its positions on one card
# (devices=[cuda:0, ...]): the same kernels launched once a position, equal
# to one device's outputs
@pytest.mark.parametrize("shape, engine", [
    ((2, 1), "mega13"), ((2, 1), "bt_fused"), ((1, 2), "conv_i8"),
    ((2, 2), "conv_i8"), ((2, 2), "gather_u32")])
def test_mesh_on_one_card_equals_one_device(card, shape, engine):
    from herdsman_tpu_torch import mesh
    from herdsman_tpu_torch.ops.server_key import layouts_for_engine

    params = KERNEL_SETS[1]   # k=2, N=256, bg=2^8, l=2: R = 6 rows
    rng = np.random.default_rng(3)
    ck, sk = ref.keygen(params, rng)
    dsk = device_server_key(sk, layouts=layouts_for_engine(engine),
                            device=card)
    bits = rng.integers(0, 2, 37).astype(bool)   # not a multiple of 2
    ct = ref.encrypt_bool(ck, bits, rng)
    m = mesh.make_mesh(*shape, devices=[card] * (shape[0] * shape[1]))
    one = bs.bootstrap_bool_batch(dsk, ct, engine=engine, device=card)
    sharded = mesh.bootstrap_bool_sharded(mesh.shard_server_key(dsk, m), m,
                                          ct, engine=engine)
    assert sharded.device == card and torch.equal(sharded, one)
    assert (ref.lwe_decrypt_bool(ck, to_numpy_u32(sharded)) == bits).all()


def test_ntt_sharded_on_one_card_equals_ntt(card):
    from herdsman_tpu_torch import mesh
    from herdsman_tpu_torch.mesh import ntt_sharded
    from herdsman_tpu_torch.ops import ntt

    N = 4096
    p = ntt.ntt_primes_for(N, 1)[0]
    plan = ntt.make_plan(p, N, device=card)
    rng = np.random.default_rng(4)
    x, y = (from_numpy_u32(rng.integers(0, p, (3, 64, N)).astype(np.uint32),
                           card) for _ in range(2))
    for limb in (2, 4):
        m = mesh.make_mesh(1, limb, devices=[card] * limb)
        spec = ntt_sharded.ntt_fwd_sharded(plan, m, x)
        assert torch.equal(spec, ntt.ntt_fwd(plan, x))
        assert torch.equal(ntt_sharded.ntt_inv_sharded(plan, m, spec), x)
        assert torch.equal(ntt_sharded.polymul_sharded(plan, m, x, y),
                           ntt.negacyclic_polymul_ntt(plan, x, y))
