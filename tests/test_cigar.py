import pytest

from guacamole.reads.cigar import OP_D, OP_I, OP_M, OP_S, Cigar


def test_parse_simple():
    c = Cigar.from_string("8M")
    assert len(c) == 1
    assert c[0].length == 8
    assert c[0].op == OP_M
    assert str(c) == "8M"


def test_parse_complex():
    c = Cigar.from_string("5M2I3M1D4M2S")
    assert [str(e) for e in c] == ["5M", "2I", "3M", "1D", "4M", "2S"]
    assert c.read_length == 5 + 2 + 3 + 4 + 2
    assert c.reference_length == 5 + 3 + 1 + 4
    assert c.padded_reference_length == 5 + 3 + 1 + 4


def test_n_and_hard_clip():
    c = Cigar.from_string("10M10N10M5H")
    assert c.read_length == 20
    assert c.reference_length == 30
    assert c.padded_reference_length == 30


def test_element_lengths():
    c = Cigar.from_string("3M2D1I")
    assert c[0].read_length == 3 and c[0].reference_length == 3
    assert c[1].read_length == 0 and c[1].reference_length == 2
    assert c[2].read_length == 1 and c[2].reference_length == 0


def test_malformed():
    with pytest.raises(ValueError):
        Cigar.from_string("8Z")
    with pytest.raises(ValueError):
        Cigar.from_string("M8")


def test_empty_and_star():
    assert len(Cigar.from_string("")) == 0
    assert len(Cigar.from_string("*")) == 0


def test_equality():
    assert Cigar.from_string("8M") == Cigar.from_string("8M")
    assert Cigar.from_string("8M") != Cigar.from_string("9M")
