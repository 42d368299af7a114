"""K6's segmented running sums (ec_kernels.wreduce_plain, the order of
additions csrc/wreduce.cu runs) and its launch geometry, on the CPU.

The plain version at any split into P segments is held to the JAX
package's python-int host oracle, sum_j (j+1) S_j per window, as affine
points: at one segment (P = 1), at one bucket a segment (P = W) and at the
geometry table's split, and with whole segments of identity buckets and
with every bucket equal (a P = Q add inside each running sum).
`wreduce_geometry` must split a window into P segments of m buckets, both
powers of two, with groups of 2, 4 or 8 threads that the kernel is built
for, and do at most 1.3x the 2 (W - 1) adds the sum needs at the 2^20,
c = 15 window shape."""

import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec import ec_kernels as ek

JSPEC, TSPEC = jcurves.BN254_G1, curves.BN254_G1
HC = jhost.host_curve(JSPEC)
NWIN = 2
SMEM = 227 * 1024  # csrc/field.cuh kMaxDynamicSmem
GROUP_SLOTS = 20  # csrc/wreduce.cu kSlots: run, acc, bucket, scaled sum, 8
MAX_SEGMENTS = 1024  # csrc/wreduce.cu kMaxSegments


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _buckets(seed, W, pattern=None, P=None):
    """(NWIN, W) projective buckets 2 [k]G (Z != 1), identity on j = 3 mod
    7, and the host points; pattern "identity segments" makes segments 1
    and P - 1 of every window all identity, "all equal" every bucket the
    same point."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=NWIN * W)]
    if pattern == "all equal":
        ks = [ks[0]] * len(ks)
    pts = [HC.affine_ints(HC.mul(HC.generator, k)) for k in ks]
    for i in range(NWIN * W):
        j = i % W
        if pattern != "all equal" and (
                j % 7 == 3 or pattern == "identity segments"
                and j // (W // P) in (1, P - 1)):
            pts[i] = None
    enc = ec.encode_points(TSPEC, [p or (0, 0) for p in pts])
    inf = torch.tensor([p is None for p in pts])[:, None]
    one = ek._plain_ops(TSPEC).one_like(enc[0])
    proj = ek.proj_double_plain(TSPEC, (
        torch.where(inf, 0, enc[0]), torch.where(inf, one, enc[1]),
        torch.where(inf, 0, one)))
    host_pts = [None if p is None else HC.double(HC.lift_affine(p))
                for p in pts]
    return tuple(x.reshape(NWIN, W, -1) for x in proj), host_pts


def _expect(host_pts, W):
    out = []
    for w in range(NWIN):
        acc = None
        for j in range(W):
            pt = host_pts[w * W + j]
            acc = HC.add(acc, None if pt is None else HC.mul(pt, j + 1))
        out.append(HC.affine_ints(acc))
    return out


def _affine(P):
    return ec.decode_points(TSPEC, ec.proj_to_jacobian(TSPEC, P))


@pytest.mark.parametrize("W,split", [(W, split) for W in (64, 128)
                                     for split in ("1", "table", "W")],
                         ids=lambda v: str(v))
def test_segments_match_host(W, split):
    """The plain version at P = 1, the table's P and P = W segments equals
    sum_j (j+1) S_j per window."""
    P = {"1": 1, "W": W, "table": ek.wreduce_geometry(W, 8)[0]}[split]
    buckets, host_pts = _buckets(60 + W, W)
    assert _affine(ek.wreduce_plain(TSPEC, buckets, segments=P)) \
        == _expect(host_pts, W)


@pytest.mark.parametrize("pattern", ["identity segments", "all equal"])
def test_edge_buckets_match_host(pattern):
    """Whole segments of identity buckets (T_p = A_p = identity, scaled),
    and every bucket equal (run + S_j is a doubling on the first step), at
    the table's split; the default split is the table's."""
    W = 128
    P = ek.wreduce_geometry(W, 8)[0]
    buckets, host_pts = _buckets(70, W, pattern, P)
    got = ek.wreduce_plain(TSPEC, buckets)
    assert all(torch.equal(a, b) for a, b in
               zip(got, ek.wreduce_plain(TSPEC, buckets, segments=P)))
    assert _affine(got) == _expect(host_pts, W)


@pytest.mark.parametrize("words,W", [(words, W) for words in (8, 12)
                                     for W in (64, 128, 4096, 16384, 32768,
                                               1 << 16)],
                         ids=lambda v: str(v))
def test_geometry_splits_every_window(words, W):
    """P segments of m = W / P buckets, both powers of two, at most the
    kernel's 1024 segments; groups of 2, 4 or 8 threads in blocks of a
    multiple of 32 threads, at most 256, whose slots and stage fit the
    shared memory a block may take, as does the tree's window of P sums."""
    P, group, threads = ek.wreduce_geometry(W, words)
    m = W // P
    assert P * m == W
    assert P & (P - 1) == 0 and m & (m - 1) == 0
    assert 1 <= P <= MAX_SEGMENTS
    assert group in (2, 4, 8)
    assert threads % 32 == 0 and 0 < threads <= 256
    groups = threads // group
    assert groups * ((GROUP_SLOTS * words + 4) * 4 + 3 * 2 * words * 8) \
        <= SMEM
    assert (3 * P + 64 * 8) * words * 4 <= SMEM


@pytest.mark.parametrize("words", [8, 12])
def test_work_within_bound_at_2p20_shape(words):
    """At 17 x 16384 buckets the segmented sum does at most 1.3x the
    2 (W - 1) adds the sum needs (segments, scale and tree)."""
    W = 16384
    P = ek.wreduce_geometry(W, words)[0]
    work = ek.wreduce_work(W, P)
    assert work["segment_adds"] == 2 * (W - P)
    assert work["tree_adds"] == P - 1
    assert sum(work.values()) <= 1.3 * 2 * (W - 1)
