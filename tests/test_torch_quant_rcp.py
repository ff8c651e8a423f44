"""CPU proof that the int8 quantize kernel's vector path (K2a,
``quant_vec_rows`` in ``csrc/quant_offload.cu``) rounds every element as the
IEEE quotient does.

The kernel computes ``t = x * rn(1 / scale)`` (one rounded product) and
``rint(t)``, and takes ``rint(x / scale)`` instead wherever ``t`` lies within
2^-14 of a half-integer.  With e = x / scale exact and u = 2^-24, t is within
e(2u + u^2) of e and the IEEE quotient within eu, so the two are within
3.0001 u |e| <= 2^-15.4 of each other (|e| <= 127 in a row whose max is
|x|'s), and only a half-integer between them can make them round apart.
Here numpy's f32 arithmetic (correctly rounded, as the card's ``__fmul_rn``,
IEEE division and ``rintf``) emulates both formulas: for every bf16 x
against a sweep of row maxima (all 128 bf16 mantissas at binades from
subnormal to 2^100, maxima under the 1e-12 clamp, and f32 maxima), and for
f32 x placed within a few ulps of every tie, the payloads are equal; the
product alone (no tie check) is not.
"""
import numpy as np
import pytest

TIE = np.float32(2.0 ** -14)


def scale_of(amax):
    """The kernel's row scale, max(amax, 1e-12) / 127 in f32."""
    return np.maximum(np.float32(amax), np.float32(1e-12)) / np.float32(127)


def quant_ieee(x, scale):
    return np.clip(np.rint(x / scale), -127, 127)


def quant_rcp(x, scale, tie_check=True):
    rcp = np.float32(1) / scale
    t = x * rcp                                   # f32 * f32: one rounding
    r = np.rint(t)
    if tie_check:
        near = np.abs(np.abs(t - r) - np.float32(0.5)) <= TIE
        r = np.where(near, np.rint(x / scale), r)
    return np.clip(r, -127, 127)


def all_bf16():
    """Every finite bf16 value, as f32."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return bits[np.isfinite(bits)]


BF16 = all_bf16()


def bf16_maxima():
    """Row maxima: every bf16 mantissa in [1, 2) at binades 2^-133 (bf16's
    subnormals are under the clamp) through 2^100, and maxima under the
    1e-12 clamp."""
    mant = np.float32(1) + np.arange(128, dtype=np.float32) / np.float32(128)
    out = [mant * np.float32(2.0 ** k) for k in (-126, -60, -41, -20, -1, 0,
                                                 1, 7, 20, 64, 100)]
    out.append(np.array([1e-13, 9.99e-13, 1e-30, 1e-38], np.float32))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("chunk", range(4))
def test_rcp_rounds_like_ieee_for_every_bf16(chunk):
    maxima = bf16_maxima()
    maxima = maxima[chunk::4]
    mismatches = checked = 0
    for amax in maxima:
        x = BF16[np.abs(BF16) <= amax]
        s = scale_of(amax)
        want = quant_ieee(x, s)
        mismatches += int((quant_rcp(x, s) != want).sum())
        checked += x.size
    assert checked > 10_000_000 // 4
    assert mismatches == 0


def test_rcp_rounds_like_ieee_near_every_tie_in_f32():
    """f32 rows: x within 8 ulps of (k + 1/2) * scale for every k, over
    random f32 maxima."""
    rng = np.random.RandomState(0)
    maxima = np.concatenate([
        rng.uniform(1e-6, 1e6, 200).astype(np.float32),
        (np.float32(2) ** rng.randint(-100, 100, 50)).astype(np.float32)])
    k = np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)
    mismatches = near_ties = 0
    for amax in maxima:
        s = scale_of(amax)
        x = (k * s).astype(np.float32)
        xs = [x]
        up, down = x.copy(), x.copy()
        for _ in range(8):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            xs += [up, down]
        x = np.concatenate(xs)
        x = x[np.abs(x) <= amax]
        want = quant_ieee(x, s)
        mismatches += int((quant_rcp(x, s) != want).sum())
        near_ties += int((quant_rcp(x, s, tie_check=False) != want).sum())
    assert mismatches == 0
    assert near_ties > 0           # the product alone rounds some ties apart


def test_product_alone_is_not_bit_identical():
    """Without the tie check some bf16 x round the other way: the check is
    what makes the fast path exact (the mutation tool's K2a fault)."""
    diffs = 0
    for amax in bf16_maxima()[::7]:
        x = BF16[np.abs(BF16) <= amax]
        s = scale_of(amax)
        diffs += int((quant_rcp(x, s, tie_check=False)
                      != quant_ieee(x, s)).sum())
    assert diffs > 0
