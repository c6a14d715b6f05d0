"""Why the fp32 paths of K1 and K3 keep three TF32 products (3xTF32).

The kernels (``csrc/hopper.cuh``: ``split_tf32``, ``mma_3xtf32``) split each
fp32 operand as ``x = hi + lo``: ``hi`` is ``x`` rounded to nearest TF32 (10
explicit mantissa bits, ties away from zero, as ``cvt.rna``), ``lo = x - hi``
is exact in fp32, and the tensor core reads only its upper 19 bits (TF32),
i.e. ``lo`` truncated.  They sum ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in
fp32.  Emulated here in numpy on seeded inputs: every TF32 product is exact
in float64 and the sum runs in float32, in the kernels' order; the
reference is the float64 sum.  The error is measured as chip_smoke.py and
tests/test_torch_kernels.py measure it on the card: max abs error over max
abs reference, against the fp32 bound of 1e-4.

Cases: dot products of length C = 320 and 1280 (K3's sites) between
normalised rows and weights scaled 1/sqrt(C) (K3), and between softmax
probabilities and values (K1's P V), 64 x 64 of each.
"""

import numpy as np
import pytest

FP32_BOUND = 1e-4  # chip_smoke.BOUND[torch.float32]


def tf32_rna(x):
    """Round float32 to TF32 (keep 10 of 23 mantissa bits), to nearest with
    ties away from zero: add half of the dropped unit to the magnitude bits,
    then mask, as cvt.rna.tf32.f32 does for finite inputs."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """The TF32 value the tensor core reads from an fp32 register: the low
    13 mantissa bits dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """(hi, lo) as the tensor core reads them."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x.astype(np.float32) - hi)


def product(a, b, terms):
    """a [M, C] @ b [C, N]: each term is a pair of TF32 operands; every
    product is exact in float64, rounded to float32 and accumulated in
    float32 over k, the terms of one k step in the given order."""
    acc = np.zeros((a[0].shape[0], b[0].shape[1]), np.float32)
    for k in range(a[0].shape[1]):
        for ia, ib in terms:
            acc += (a[ia][:, k:k + 1].astype(np.float64)
                    * b[ib][k:k + 1, :].astype(np.float64)).astype(np.float32)
    return acc


def inputs(kind, c, seed):
    rng = np.random.default_rng(seed)
    if kind == "ln_matmul":  # normalised rows x weights of nn.Linear scale
        a = rng.standard_normal((64, c))
        b = rng.standard_normal((c, 64)) / np.sqrt(c)
    else:  # softmax probabilities of scores at scale 1/8 x values
        s = rng.standard_normal((64, c)) * np.sqrt(64) * 0.125 * 3
        p = np.exp(s - s.max(axis=1, keepdims=True))
        a = p / p.sum(axis=1, keepdims=True)
        b = rng.standard_normal((c, 64))
    return a.astype(np.float32), b.astype(np.float32)


def errors(kind, c, seed=0):
    """(3xTF32 error, one-TF32-product error), each max abs / max abs ref."""
    a, b = inputs(kind, c, seed)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    (ahi, alo), (bhi, blo) = split(a), split(b)
    three = product((ahi, alo), (bhi, blo), [(1, 0), (0, 1), (0, 0)])
    one = product((ahi,), (bhi,), [(0, 0)])
    scale = np.abs(ref).max()
    return np.abs(three - ref).max() / scale, np.abs(one - ref).max() / scale


CASES = [(kind, c) for kind in ("ln_matmul", "attention") for c in (320, 1280)]


def test_split_is_two_tf32_values_within_2_to_the_minus_21():
    x = np.random.default_rng(1).standard_normal(100_000).astype(np.float32) * 10.0
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()  # 10 mantissa bits
    rel = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x.astype(np.float64))
    assert rel.max() <= 2.0 ** -21
    assert np.abs(x - hi).max() > 0  # hi alone is not exact
    # hi is round to nearest: never further from x than half a TF32 unit
    assert (np.abs(x.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(hi)).all()


@pytest.mark.parametrize("kind,c", CASES)
def test_three_tf32_products_stay_10x_under_the_fp32_bound(kind, c):
    three, _ = errors(kind, c)
    assert three * 10 <= FP32_BOUND, three


@pytest.mark.parametrize("kind,c", CASES)
def test_three_tf32_products_beat_one_by_100x(kind, c):
    three, one = errors(kind, c)
    assert one >= 100 * three, (one, three)
    assert one > FP32_BOUND / 10  # one TF32 product is no fp32 kernel
