"""K4's adds are counted before the window, once for each of a job's
distinct inputs, and handed to the window's launches by their job's input
(`hooks.count_k4_adds`, `hooks.k4_window`). K4 runs on the card alone, so
the launch is a stand-in here that only takes its flags."""

import pytest
import torch

from cosnarks_tpu_torch.ec import ec_kernels
from cosnarks_tpu_torch.ec.curves import BN254_G1

from portbench import hooks


class FakeJob:
    """Job k launches K4 twice on input k % 2; input i has i + 1 adds in
    its first launch and 3 in its second."""
    distinct_inputs = 2

    def run_one(self, k):
        i = k % 2
        first = torch.zeros((4, 8), dtype=torch.int64)
        first.view(-1)[: i + 1] = 2  # valid, not a segment's start
        second = torch.full((4, 8), 1, dtype=torch.int64)
        second.view(-1)[:3] = 2
        ec_kernels.fold_launch(BN254_G1, (), first, 4, False)
        ec_kernels.fold_launch(BN254_G1, (), second, 4, True)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(ec_kernels, "fold_launch",
                        lambda spec, q, flags, K, proj_q: None)
    c = hooks.Counters()
    undo = hooks.install({"k4_launches"}, c)
    yield c
    undo()


def test_adds_are_counted_before_the_window_alone(counters):
    job = FakeJob()
    per_input = hooks.count_k4_adds(job, counters)
    assert per_input == [[(8, False, 8, 4, 1), (8, True, 8, 4, 3)],
                         [(8, False, 8, 4, 2), (8, True, 8, 4, 3)]]
    assert counters.k4 == [] and not counters.count_adds
    for k in range(3):  # the window: shapes filed, no adds counted
        job.run_one(k)
    assert [launch[4] for launch in counters.k4] == [None] * 6
    assert hooks.k4_window(counters.k4, per_input, 3) == (
        per_input[0] + per_input[1] + per_input[0])


def test_a_window_unlike_its_inputs_reads_nothing(counters):
    per_input = hooks.count_k4_adds(FakeJob(), counters)
    FakeJob().run_one(0)
    assert hooks.k4_window(counters.k4, per_input, 2) == []
    assert hooks.k4_window(counters.k4, None, 1) == []
    assert hooks.count_k4_adds(object(), counters) is None
