"""fhebench/roofline.py against values worked by hand at B = 2048."""

import pytest

from fhebench import roofline

K2 = {"n": 768, "N": 512, "k": 2, "levels": 2}
TFHE_LIB = {"n": 630, "N": 1024, "k": 1, "levels": 3}


def test_std128_k2():
    ops, nbytes = roofline.rotation(K2, 2048)
    # 2 * 768 * 2048 * (6 * 512) * (3 * 4 * 512)
    assert ops == 59_373_627_899_904
    # accumulators in and out 25,165,824 + masks 6,291,456 + raw key
    # 768 * 6 * 3 * 512 u32 28,311,552
    assert nbytes == 59_768_832
    assert roofline.bound_s(K2, 2048) * 1e3 == pytest.approx(30.0018,
                                                             abs=1e-4)


def test_tfhe_lib_default():
    ops, nbytes = roofline.rotation(TFHE_LIB, 2048)
    # 2 * 630 * 2048 * (6 * 1024) * (2 * 4 * 1024)
    assert ops == 129_879_811_031_040
    # accumulators in and out 33,554,432 + masks 5,160,960 + raw key
    # 630 * 6 * 2 * 1024 u32 30,965,760
    assert nbytes == 69_681_152
    assert roofline.bound_s(TFHE_LIB, 2048) * 1e3 == pytest.approx(
        65.6290, abs=1e-4)


def test_share_of_recorded_calls():
    run = {"config": {"params": K2},
           "rotations": [(2048, 100.0), (2048, 50.0)]}
    assert roofline.share(run) == pytest.approx(
        100 * 2 * roofline.bound_s(K2, 2048) / 0.150)
    assert roofline.share({"config": {"params": K2}, "rotations": []}) \
        is None
