"""The reference on the CPU: keys, encryption and decryption round-trip,
and the plaintext plans give the answers of the smoke run's paths B and C
(chip_smoke.py), worked here by hand."""

import torch

from fhebench.reference import plans, tfhe

TOY = tfhe.Params(n=16, N=64, k=1, bg_bits=6, levels=3, ks_base_bits=4,
                  ks_levels=3, lwe_std=0.5, glwe_std=0.5)
SET = tfhe.Params(n=64, N=256, k=1, bg_bits=7, levels=3, ks_base_bits=3,
                  ks_levels=5, lwe_std=2.0, glwe_std=2.0)


def test_keys_are_the_seeds():
    a, b = tfhe.keygen(TOY, 2**31 + 5, "cpu"), tfhe.keygen(TOY, 2**31 + 5,
                                                           "cpu")
    c = tfhe.keygen(TOY, 2**31 + 6, "cpu")
    assert torch.equal(a.bsk, b.bsk) and torch.equal(a.ksk, b.ksk)
    assert not torch.equal(a.bsk, c.bsk)
    assert a.bsk.shape == (16, 6, 2, 64) and a.ksk.shape == (64, 3, 17)
    assert int(a.bsk.min()) >= 0 and int(a.bsk.max()) <= tfhe.MASK


def test_bool_round_trip():
    keys = tfhe.keygen(SET, 7, "cpu")
    gen = tfhe.generator(7, 2, "cpu")
    bits = tfhe.bits((500,), gen)
    ct = tfhe.encrypt(keys.lwe_key, tfhe.encode_bool(bits), SET.lwe_std, gen)
    wrong, err = tfhe.judge_bool(tfhe.phase(keys.lwe_key, ct), bits)
    assert wrong == 0 and err < 1e-6
    wrong, _ = tfhe.judge_bool(tfhe.phase(keys.lwe_key, ct), 1 - bits)
    assert wrong == 500


def test_key_switching_key_encrypts_the_extracted_key():
    keys = tfhe.keygen(SET, 9, "cpu")
    ph = tfhe.centred(tfhe.phase(keys.lwe_key, keys.ksk))   # [kN, t]
    scale = torch.tensor([1 << (32 - 3 * (t + 1)) for t in range(5)])
    want = keys.glwe_key.reshape(-1)[:, None] * scale
    assert int((ph - want).abs().max()) < 64       # lwe_std 2


def test_bootstrapping_key_rows():
    """Row (j, i) of GGSW(m) decrypts under the GLWE key to -s_j m q/Bg^(i+1)
    (j < k) or m q/Bg^(i+1) at coefficient 0 (j = k)."""
    keys = tfhe.keygen(TOY, 10, "cpu")
    p = TOY
    mask = keys.bsk[:, :, :p.k, :]
    body = keys.bsk[:, :, p.k, :]
    ph = tfhe.centred(body - tfhe.poly_dot_binary(mask, keys.glwe_key))
    m = keys.lwe_key
    for i in range(p.levels):
        f = m * (1 << (32 - p.bg_bits * (i + 1)))
        want_k = torch.zeros(p.n, p.N, dtype=torch.int64)
        want_k[:, 0] = f
        got_k = ph[:, p.k * p.levels + i]
        assert int(tfhe.centred(got_k - want_k).abs().max()) < 8
        want_0 = tfhe.centred(-f[:, None] * keys.glwe_key[0][None, :])
        assert int(tfhe.centred(ph[:, i] - want_0).abs().max()) < 8


def test_negacyclic_matrix():
    s = torch.tensor([1, 0, 1, 1])
    a = torch.tensor([[3, 5, 7, 11]])
    # (3 + 5X + 7X^2 + 11X^3)(1 + X^2 + X^3) mod X^4 + 1, with X^4 = -1:
    # 1: 3 - 5 - 7, X: 5 - 7 - 11, X^2: 3 + 7 - 11, X^3: 3 + 5 + 11
    assert tfhe.poly_dot_binary(a[:, None, :], s[None, :]).tolist() == [
        [-9 & tfhe.MASK, -13 & tfhe.MASK, -1 & tfhe.MASK, 19]]


def test_batch_plan_answers():
    a = torch.tensor([0b10110010, 255, 0, 17])
    b = torch.tensor([0b01100011, 255, 1, 16])
    m = plans.xor_parity(a, b)
    assert m["x"].tolist() == [0b11010001, 0, 1, 1]
    assert m["odd"].tolist() == [0, 0, 1, 1]
    assert int(plans.xor_reduce(m["x"])) == 0b11010001
    bits = plans.row_bits([m["x"], m["odd"]], [8, 1])
    assert bits[0].tolist() == [1, 0, 0, 0, 1, 0, 1, 1, 0]


def test_adder_answers():
    a, b = torch.tensor([200, 13, 255]), torch.tensor([100, 11, 1])
    assert plans.add8(a, b).tolist() == [44, 24, 0]
    assert plans.row_bits([plans.add8(a, b)], [8])[0].tolist() == [
        0, 0, 1, 1, 0, 1, 0, 0]
