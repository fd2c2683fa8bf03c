from guacamole.utils import bases as Bases
from guacamole.utils import phred


def test_standard_bases():
    assert Bases.is_standard_base(Bases.A)
    assert Bases.is_standard_base(Bases.C)
    assert Bases.is_standard_base(Bases.G)
    assert Bases.is_standard_base(Bases.T)
    assert not Bases.is_standard_base(Bases.N)
    assert not Bases.is_standard_base(ord("X"))


def test_complement():
    assert Bases.complement(Bases.A) == Bases.T
    assert Bases.complement(Bases.T) == Bases.A
    assert Bases.complement(Bases.C) == Bases.G
    assert Bases.complement(Bases.G) == Bases.C
    assert Bases.complement(Bases.N) == Bases.N
    assert Bases.complement_seq(b"ACGTN") == b"TGCAN"
    assert Bases.reverse_complement(b"AACG") == b"CGTT"


def test_string_conversion():
    assert Bases.string_to_bases("acGtn") == b"ACGTN"
    assert Bases.bases_to_string(b"ACGT") == "ACGT"
    assert Bases.unmask(b"acGtn") == b"ACGTN"


def test_all_standard():
    assert Bases.all_standard_bases(b"ACGT")
    assert not Bases.all_standard_bases(b"ACGTN")


def test_phred_conversions():
    assert abs(phred_success(10) - 0.9) < 1e-9
    assert abs(phred_success(20) - 0.99) < 1e-9
    assert phred.success_probability_to_phred(0.9) == 10
    assert phred.success_probability_to_phred(0.99) == 20
    # the small-delta convention used for phred-scaling likelihoods of 1.0
    assert phred.success_probability_to_phred(1.0 - 1e-10) == 100


def phred_success(q):
    return phred.phred_to_success_probability(q)
