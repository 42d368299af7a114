"""The port's multi-device module (cosnarks_tpu_torch/multidevice.py) on
the CPU: `entry()`'s step, limb for limb, against the JAX package's own
modules (`groth16.witness_map.sparse_matvec`, `poly.ntt`, `ff.mont`)
composed the same way on the same numpy inputs; `dryrun_multichip` over
gloo at 2 and 4 spawned ranks, each checking the sharded step against one
device's and both MSMs against the host curve; and a refusal when asked
for more devices than exist."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu.ff.spec import BN254_FR as JF
from cosnarks_tpu.groth16.witness_map import sparse_matvec as jmatvec
from cosnarks_tpu.poly import ntt as jntt
from cosnarks_tpu_torch import multidevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    yield
    torch.set_num_threads(threads)


def _jax_step(n, seed=0):
    """The step through the JAX package on the same numpy draws."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=8 * n).astype(np.uint32)
    cols = rng.integers(0, 4 * n, size=8 * n).astype(np.uint32)

    def rand_field(shape):
        limbs = rng.integers(0, 1 << 15, size=shape + (JF.nlimbs,))
        limbs[..., -1] &= (1 << 13) - 1
        return jnp.asarray(limbs.astype(np.uint32))

    vals = rand_field((8 * n,))
    w = rand_field((4 * n,))
    zero = jmont.zeros(JF, (n,))
    dom = jntt.groth16_domain(JF, n)
    root = jntt.groth16_shift_root(JF, dom)
    rows, cols = jnp.asarray(rows), jnp.asarray(cols)
    a = jmatvec(JF, rows, cols, vals, w, n)
    b = jmatvec(JF, cols % np.uint32(n), rows % np.uint32(4 * n), vals, w, n)
    c = jmont.mul(JF, a, b)

    def shift(x):
        return dom.fft(dom.distribute_powers(dom.ifft(x), root))

    a, b, c = shift(a), shift(b), shift(c)
    return jmont.sub(JF, jmont.add(JF, jmont.mul(JF, a, b), zero), c)


def test_entry_step_matches_jax_modules():
    step, args = multidevice.entry(device="cpu")
    w, vals, zero = args
    assert w.shape == (4096, 16) and vals.shape == (8192, 16)
    got = step(*args)
    assert got.shape == (1024, 16) and got.device.type == "cpu"
    want = np.asarray(_jax_step(1 << 10)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multichip_on_gloo(ranks):
    out = multidevice.dryrun_multichip(ranks, device="cpu", timeout_s=240)
    assert [o["rank"] for o in out] == list(range(ranks))
    assert all(o["world"] == ranks and o["msm_points"] == 64 * ranks
               for o in out)
    # every rank opened the same points
    assert len({(str(o["tree_msm"]), str(o["sharded_msm"]))
                for o in out}) == 1


def test_dryrun_multichip_refuses_more_devices_than_exist():
    with pytest.raises(RuntimeError, match="need"):
        multidevice.dryrun_multichip((os.cpu_count() or 1) + 1,
                                     device="cpu")
