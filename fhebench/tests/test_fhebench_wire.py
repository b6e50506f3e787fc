"""The reference's wire form of a frame: a known row laid out by hand, the
same bytes as the program's framing of the same rows, and torn frames
refused."""

import numpy as np
import pytest
import torch

from fhebench.reference import tfhe, wire
from herdsman_tpu_torch.service import frames
from herdsman_tpu_torch.utils import rowcodec


def test_a_known_row():
    """One row of one bit at n = 1: size 8, then mask and body, each u32
    little-endian."""
    ct = torch.tensor([[[0x01020304, 0xA0B0C0D0]]])
    data = wire.frame(ct)
    assert data == bytes([8, 0, 0, 0, 4, 3, 2, 1, 0xD0, 0xC0, 0xB0, 0xA0])
    assert torch.equal(wire.parse(data, 1, 1), ct)


def test_the_programs_framing_of_the_same_rows():
    cts = tfhe.uniform((5, 9, 17), tfhe.generator(2**31 + 1, 0, "cpu"))
    program = rowcodec.frame_rows(
        frames.rows_to_payloads(cts.numpy().astype(np.uint32)))
    assert wire.frame(cts) == program
    assert torch.equal(wire.parse(program, 9, 16), cts)


def test_torn_frames_are_refused():
    data = wire.frame(tfhe.uniform((3, 2, 5), tfhe.generator(3, 0, "cpu")))
    assert wire.parse(b"", 2, 4).shape == (0, 2, 5)
    with pytest.raises(ValueError, match="whole number"):
        wire.parse(data[:-1], 2, 4)
    with pytest.raises(ValueError, match="row sizes"):
        wire.parse(data, 4, 7)   # three 44-byte rows read as one of 132
