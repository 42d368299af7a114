"""The kernel wrappers' launch-size histogram and K1's tile walk, on the CPU.

`mont_kernel.count` files every launch under the power of two at or above
its batch, and the wrappers' modes (words, op) keep the 8- and 12-word
builds apart; a CPU call of any wrapper runs the plain version and counts
nothing; `mul_geometry` / `mul_tiles` are the persistent grid that
csrc/mont_mul.cu walks at either width, and must cover every element
exactly once in 16-byte pieces; every kernel is built at both widths, and
K5 and K6 launch their field's build and count under (words, op)."""

import contextlib
import types

import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch import _build
from cosnarks_tpu_torch.ec import ec_kernels as ek
from cosnarks_tpu_torch.ec.curves import BLS12_381_G1, BN254_G1
from cosnarks_tpu_torch.ff import mont_kernel
from cosnarks_tpu_torch.ff.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ

H100_SMS = 132
SMEM_PER_SM = 227 * 1024  # shared memory a block may use on Hopper
ROW_BYTES = {8: 144, 12: 208}  # csrc/field.cuh kRowBytes at each width
MAX_TILE = 256  # csrc/mont_mul.cu kMaxTile
COUNTERS = (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
            ek.fold_launch, ek.madd_launch, ek.wreduce_launch)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("total,bucket", [(1, 1), (2, 2), (3, 4), (4, 4),
                                          (1 << 15, 1 << 15),
                                          ((1 << 15) + 1, 1 << 16)])
def test_size_bucket_edges(total, bucket):
    assert mont_kernel.size_bucket(total) == bucket


def test_count_files_launch_and_size():
    def wrapper():
        pass

    wrapper.launches, wrapper.sizes = {}, {}
    for mode, total in ((0, 3), (0, 4), (1, 3), (0, 5)):
        mont_kernel.count(wrapper, mode, total)
    assert wrapper.launches == {0: 3, 1: 1}
    assert wrapper.sizes == {(0, 4): 2, (1, 4): 1, (0, 8): 1}


def _fe(rng, *shape):
    """Canonical random limbs (top limb below 2^13, so below p)."""
    x = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] &= 0x1FFF
    return torch.from_numpy(x)


def _calls():
    rng = np.random.default_rng(0x5125)
    g1, n, K, L = BN254_G1, 3, 2, 3
    P = tuple(_fe(rng, n) for _ in range(3))
    Q = tuple(_fe(rng, n) for _ in range(3))
    valid = torch.tensor([True, False, True])
    q = [_fe(rng, K, L).permute(2, 0, 1).contiguous() for _ in range(3)]
    packed = [(c[0::2] | (c[1::2] << 16)).contiguous() for c in q[:2]]
    flags = torch.from_numpy(rng.integers(0, 8, size=(K, L),
                                          dtype=np.int64))
    buckets = tuple(_fe(rng, 1, 64) for _ in range(3))
    return {
        "K1 mul": lambda: mont_kernel.mul(BN254_FQ, P[0], Q[0]),
        "K2 add": lambda: ek.add(g1, P, Q),
        "K2 double": lambda: ek.double(g1, P),
        "K3 proj_add": lambda: ek.proj_add(g1, P, Q),
        "K3 proj_madd masked": lambda: ek.proj_madd(g1, P, Q[:2], valid),
        "K3 proj_double": lambda: ek.proj_double(g1, P),
        "K4 level0_fold": lambda: ek.level0_fold(g1, *packed, flags, K),
        "K4 proj_fold": lambda: ek.proj_fold(g1, *q, flags, K),
        "K5 madd": lambda: ek.madd(g1, P, Q[:2], valid),
        "K6 weighted_bucket_sum": lambda: ek.weighted_bucket_sum(g1,
                                                                 buckets),
    }


@pytest.mark.parametrize("name", [
    "K1 mul", "K2 add", "K2 double", "K3 proj_add", "K3 proj_madd masked",
    "K3 proj_double", "K4 level0_fold", "K4 proj_fold", "K5 madd",
    "K6 weighted_bucket_sum"])
def test_cpu_call_counts_nothing(name):
    before = [(dict(c.launches), dict(c.sizes)) for c in COUNTERS]
    out = _calls()[name]()
    assert all(t.device.type == "cpu" for t in
               (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor))
    assert [(dict(c.launches), dict(c.sizes)) for c in COUNTERS] == before


@pytest.mark.parametrize("total,words", [
    pytest.param(total, words,
                 id=str(total) if words == 8 else f"{total}-{words}words")
    for words in (8, 12)
    for total in (1, 3, 127, 128, 1 << 15, 3 * 40960, (1 << 20) + 5)])
def test_k1_tile_walk_covers_every_element_once(total, words):
    tile, blocks = mont_kernel.mul_geometry(total, H100_SMS)
    assert tile % 32 == 0 and 0 < tile <= MAX_TILE
    assert mont_kernel.MUL_BLOCKS_PER_SM * 4 * tile * ROW_BYTES[words] \
        <= SMEM_PER_SM
    ntiles = -(-total // tile)
    assert 1 <= blocks <= min(ntiles, mont_kernel.MUL_BLOCKS_PER_SM
                              * H100_SMS)
    walk = mont_kernel.mul_tiles(total, tile, blocks, words)
    assert {blk for blk, *_ in walk} == set(range(blocks))  # none idle
    seen = np.zeros(total, dtype=np.int64)
    for blk, first, count, nbytes in walk:
        assert first % tile == 0 and (first // tile) % blocks == blk
        assert 0 < count <= tile
        assert nbytes == count * mont_kernel.element_bytes(words)
        assert nbytes == count * (ROW_BYTES[words] - 16)
        assert nbytes % 16 == 0
        seen[first:first + count] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("field,words", [(BN254_FQ, 8), (BLS12_381_FR, 8),
                                         (BLS12_381_FQ, 12)],
                         ids=["bn254_fq", "bls12_381_fr", "bls12_381_fq"])
def test_launch_modes_tell_the_widths_apart(field, words):
    """A field's width picks its kernel build, and a launch counted under
    (words, op) files apart from the other width's."""
    assert mont_kernel.field_words(field) == words
    assert len(mont_kernel.field_params(field)) == 2 * words + 1
    stems = {name for name, w in _build.builds() if w == words}
    assert stems == set(_build.KERNELS)

    def wrapper():
        pass

    wrapper.launches, wrapper.sizes = {}, {}
    mont_kernel.count(wrapper, (words, 0), 3)
    mont_kernel.count(wrapper, (20 - words, 0), 3)
    assert wrapper.launches == {(words, 0): 1, (20 - words, 0): 1}
    assert wrapper.sizes == {((words, 0), 4): 1, ((20 - words, 0), 4): 1}


@pytest.mark.parametrize("kernel", ["K5", "K5 masked", "K6"])
def test_k5_k6_launch_their_width_and_count_under_it(kernel, monkeypatch):
    """K5 and K6 are among the 12-word builds; on a BLS12-381 G1 field their
    launch wrappers load the 12-word library, launch at the 12-word
    geometry (`madd_geometry`, `wreduce_geometry`) and count the launch
    under (12, op, curve) (K6: (12, W, curve)). The card is replaced by a
    recorder: the wrappers' device checks pass CPU tensors and the launch
    records its entry point and arguments."""
    assert {("jacobian_madd", 12), ("wreduce", 12)} <= set(_build.builds())
    loaded, launched = [], []

    def load(name, words=8):
        loaded.append((name, words))
        return types.SimpleNamespace(cosnarks_jacobian_madd="K5",
                                     cosnarks_wreduce="K6")

    monkeypatch.setattr(ek._build, "load", load)
    monkeypatch.setattr(ek, "launch", lambda fn, *a: launched.append((fn, a)))
    monkeypatch.setattr(ek, "check_operands", lambda *a: None)
    monkeypatch.setattr(ek, "check_aligned", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    for fn in (ek.madd_launch, ek.wreduce_launch):
        monkeypatch.setattr(fn, "launches", {})
        monkeypatch.setattr(fn, "sizes", {})
    x = torch.zeros((4, 24), dtype=torch.int64)
    if kernel == "K6":
        W = 64
        P, group, threads = ek.wreduce_geometry(W, 12)
        ek.wreduce_launch(BLS12_381_G1,
                          [torch.zeros((2, W, 24), dtype=torch.int64)] * 3)
        assert loaded == [("wreduce", 12)]
        assert ek.wreduce_launch.launches == {(12, W, "bls12_381_g1"): 1}
        fn, args = launched[0]
        assert fn == "K6"
        assert [a.value for a in args[7:13]] == [2, W, P, 3 * 4, group,
                                                 threads]
    else:
        valid = torch.ones(4, dtype=torch.int64) if "masked" in kernel \
            else None
        ek.madd_launch(BLS12_381_G1, [x] * 5, valid)
        mode = ek.MADD_MASKED if valid is not None else ek.MADD
        assert loaded == [("jacobian_madd", 12)]
        assert ek.madd_launch.launches == {(12, mode, "bls12_381_g1"): 1}
        fn, args = launched[0]
        assert fn == "K5" and args[0].value == mode
        assert [a.value for a in args[10:14]] == [4, *ek.madd_geometry(4, 12)]
