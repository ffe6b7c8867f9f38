"""The frozen G1 and Fr arithmetic of the reference, held to known answers."""

import random

import pytest
import torch

from reference import fr, g1
from reference.system import ControlSystem, ReferenceSystem, encode_points, weighted_sums

# 2G and 0xdeadbeef * G, affine (standard form): published values of the
# BLS12-381 G1 generator's multiples, as independent implementations give them.
TWO_G = (0x0572CBEA904D67468808C8EB50A9450C9721DB309128012543902D0AC358A62AE28F75BB8F1C7C42C39A8C5529BF0F4E,
         0x166A9D8CABC673A322FDA673779D8E3822BA3ECB8670E461F73BB9021D5FD76A4C56D9D4CD16BD1BBA86881979749D28)
DEADBEEF_G = (0x0CCCB5BAB2944A1BDC721C97F3AFFA035D507C78FE442A9284982BD4C27617B33F1D46E8191A1EDA03D73C357752D219,
              0x17D27921BB2A717E559A1CC2C6985A2EF9307CA300A00EFE022F8FA90A468CF6875ECDEED4494191177A79564359FF26)


def test_g1_known_multiples():
    assert g1.is_on_curve(g1.G)
    assert g1.multiple(2) == TWO_G
    assert g1.multiple(0xDEADBEEF) == DEADBEEF_G
    assert g1.multiple(g1.R) is None
    assert g1.multiple(g1.R - 1) == (g1.G[0], g1.P - g1.G[1])
    three = g1.to_affine(g1.add(g1.scalar_mul(2), g1.from_affine(g1.G)))
    assert three == g1.multiple(3) and g1.is_on_curve(three)
    assert g1.add(g1.scalar_mul(5), g1.scalar_mul(g1.R - 5))[2] == 0


def test_fr_constants():
    w = fr.root_of_unity(32)
    assert pow(w, 1 << 31, fr.R) == fr.R - 1
    assert pow(fr.GENERATOR, (fr.R - 1) // 2, fr.R) == fr.R - 1
    assert fr.from_mont(fr.to_mont(12345)) == 12345


def _rand(rng, n):
    vals = [0, 1, fr.R - 1] + [rng.randrange(fr.R) for _ in range(n - 3)]
    return vals, fr.limbs_of([fr.to_mont(v) for v in vals])


def test_fr_products_and_sums_match_integers():
    rng = random.Random(7)
    a, ta = _rand(rng, 40)
    b, tb = _rand(rng, 40)
    prod = [fr.from_mont(x) for x in fr.ints_of(fr.mont_mul(ta, tb))]
    assert prod == [x * y % fr.R for x, y in zip(a, b)]
    assert [fr.from_mont(x) for x in fr.ints_of(fr.add(ta, tb))] == [(x + y) % fr.R for x, y in zip(a, b)]
    assert [fr.from_mont(x) for x in fr.ints_of(fr.sub(ta, tb))] == [(x - y) % fr.R for x, y in zip(a, b)]
    lazy = fr.ints_of(fr.mont_mul(ta, tb, reduce=False))
    assert all(x < 2 * fr.R for x in lazy)
    assert [x % fr.R for x in lazy] == fr.ints_of(fr.mont_mul(ta, tb))


def _naive(vals, root):
    n = len(vals)
    return [sum(v * pow(root, j * k, fr.R) for j, v in enumerate(vals)) % fr.R for k in range(n)]


@pytest.mark.parametrize("log_n", [0, 1, 4, 6])
def test_ntt_matches_the_definition(log_n):
    rng = random.Random(log_n)
    n = 1 << log_n
    cols = [[rng.randrange(fr.R) for _ in range(n)] for _ in range(2)]
    x = torch.stack([fr.limbs_of([fr.to_mont(v) for v in c]) for c in cols], dim=1)
    w = fr.root_of_unity(log_n)
    y = fr.ntt(x)
    for j, c in enumerate(cols):
        assert [fr.from_mont(v) for v in fr.ints_of(y[:, j])] == _naive(c, w)
    shift = fr.GENERATOR
    yc = fr.coset_ntt(x, shift)
    for j, c in enumerate(cols):
        want = [sum(v * pow(shift * pow(w, k, fr.R), i, fr.R) for i, v in enumerate(c)) % fr.R
                for k in range(n)]
        assert [fr.from_mont(v) for v in fr.ints_of(yc[:, j])] == want
    assert torch.equal(fr.intt(y), x)
    assert torch.equal(fr.coset_intt(yc, shift), x)


def test_powers_and_vanishing_inverse():
    got = [fr.from_mont(v) for v in fr.ints_of(fr.powers(5, 37))]
    assert got == [pow(5, i, fr.R) for i in range(37)]
    log_n, log_ext = 3, 5
    inv = [fr.from_mont(v) for v in fr.vanishing_inverse(log_n, log_ext)]
    w = fr.root_of_unity(log_ext)
    for i in range(1 << log_ext):
        x = fr.GENERATOR * pow(w, i, fr.R) % fr.R
        assert (pow(x, 1 << log_n, fr.R) - 1) * inv[i % len(inv)] % fr.R == 1


def test_commitments_of_the_reference_and_its_control():
    rng = random.Random(3)
    ks = torch.tensor([3, 11, 17, 65535])
    vals = [[rng.randrange(fr.R) for _ in range(8)] for _ in range(2)]
    mont = torch.stack([fr.limbs_of([fr.to_mont(v) for v in c]) for c in vals], dim=1)
    assert weighted_sums(mont, ks) == [
        sum(fr.to_mont(v) * int(ks[i % 4]) for i, v in enumerate(c)) for c in vals]

    class Inputs:
        coset_shift, zh_inv = fr.GENERATOR, None

    Inputs.ks = ks
    want = [g1.multiple(sum(v * int(ks[i % 4]) for i, v in enumerate(c))) for c in vals]
    assert ReferenceSystem(Inputs).msm(mont) == want
    cut = [g1.multiple(sum((v % (1 << 240)) * int(ks[i % 4]) for i, v in enumerate(c)))
           for c in vals]
    assert ControlSystem(Inputs).msm(mont) == cut
    enc = encode_points([TWO_G, None])
    x = sum(int(enc[i, 0]) << (16 * i) for i in range(24))
    assert x * pow(g1.FQ_MONT, -1, g1.P) % g1.P == TWO_G[0]
    assert enc[-1].tolist() == [0, 1] and not enc[:48, 1].any()
