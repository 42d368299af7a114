"""The work a kernel or an MSM needs, counted from its inputs, and the card's
peaks, for the roofline shares.

A share of a roofline is the least time the card could take over the time
it took; the least time is the larger of operations over the peak rate and
bytes over the peak bandwidth.

Operations are 32-bit integer multiply instructions. A Montgomery product of
s 32-bit words by CIOS needs 2 s^2 word products, each a low and a high
multiply, plus s multiplies for the reduction factors: 4 s^2 + s (264 at
s = 8, BN254). An H100 SXM runs 64 such multiplies a clock on each of its
132 SMs at its 1980 MHz boost clock: 16.73e12 a second. That peak is derived
from the SM's integer units, not published by NVIDIA.

Bytes are the field's own: 32 bytes for a BN254 element, whatever layout the
program keeps them in. Each input is read once and each output written once.
"""

from __future__ import annotations

import math

H100_SMS = 132
H100_IMUL_PER_SM_CLOCK = 64
H100_BOOST_HZ = 1.98e9
PEAK_IMUL_PER_S = H100_SMS * H100_IMUL_PER_SM_CLOCK * H100_BOOST_HZ
PEAK_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet (H100 SXM)

FIELD_BYTES = 32  # one BN254 Fq or Fr element
WORDS = 8  # 32-bit words of a BN254 element

# Field products of a point operation on a short Weierstrass curve with
# a = 0, the cheapest published formulas (EFD): a mixed add of an affine
# point into a Jacobian one, madd-2007-bl, 7M + 4S; a general add,
# add-2007-bl, 11M + 5S.
MADD_PRODUCTS = 11
ADD_PRODUCTS = 16


def mont_mul_ops(words: int = WORDS) -> int:
    """32-bit multiplies of one Montgomery product of `words` words."""
    return 4 * words * words + words


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_IMUL_PER_S, nbytes / PEAK_BYTES_PER_S)


def k1_work(products: int, words: int = WORDS) -> tuple[int, int]:
    """(ops, bytes) of `products` elementwise Montgomery products: two
    inputs read and one output written a product."""
    return (products * mont_mul_ops(words),
            products * 3 * words * 4)


def k4_work(adds: int, lanes: int, steps: int, projective: bool,
            words: int = WORDS) -> tuple[int, int]:
    """(ops, bytes) of one bucket-fold launch over `lanes` lanes of `steps`
    sorted entries each, of which `adds` add a point into a running sum
    (valid entries that do not start a bucket): a mixed add each for level
    0's affine points, a general add for a later level's projective ones;
    every entry's point read, every step's running sum written (three
    coordinates), and each lane's run and prefix sums written."""
    elem = words * 4
    per_add = ADD_PRODUCTS if projective else MADD_PRODUCTS
    point_in = (3 if projective else 2) * elem
    entries = lanes * steps
    nbytes = entries * point_in + entries * 3 * elem + lanes * 6 * elem
    return adds * per_add * mont_mul_ops(words), nbytes


def pippenger_adds(n: int, scalar_bits: int) -> tuple[int, int]:
    """(point adds, window width) of the cheapest signed-digit Pippenger
    for n points of `scalar_bits`-bit scalars: ceil(b / c) windows, each
    adding every point into one of 2^(c-1) buckets and summing the buckets
    with two adds each, at the c that minimises the count. This depends on
    n and b alone, not on the window a program picks."""
    best = None
    for c in range(1, 32):
        adds = math.ceil(scalar_bits / c) * (n + 2 ** c)
        if best is None or adds < best[0]:
            best = (adds, c)
    return best


def msm_work(n: int, scalar_bits: int = 254,
             words: int = WORDS) -> tuple[int, int]:
    """(ops, bytes) of an n-point G1 MSM: the cheapest Pippenger's adds,
    all counted as mixed adds; n affine points and n scalars read, one
    point written."""
    adds, _ = pippenger_adds(n, scalar_bits)
    elem = words * 4
    return (adds * MADD_PRODUCTS * mont_mul_ops(words),
            n * (2 * elem + elem) + 3 * elem)
