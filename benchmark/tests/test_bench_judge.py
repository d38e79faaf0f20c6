"""Which answers of a lane the comparison lets stand: the plain solve's,
the escalation re-solve's, or either where float32 cannot decide."""

import pytest
import torch

import judge
from reference import rti as ref

PLAIN = ref.Solver()
ESCALATING = ref.Solver(escalate_iters=32, escalate_mu_tol=1e-9,
                        escalate_capacity=2)


def test_without_escalation_only_the_plain_answer_stands():
    ok_plain, ok_esc = judge.allowed(torch.tensor([1e-12, 1.0]), PLAIN)
    assert ok_plain.tolist() == [True, True]
    assert ok_esc.tolist() == [False, False]


@pytest.mark.parametrize("mu,plain,esc", [
    # settled, in the band around the tolerance, escalated
    ([1e-12, 5e-9, 1.0], [True, True, False], [False, True, True]),
    # three lanes above the tolerance for two places: any may keep its
    # plain answer
    ([1.0, 2.0, 3.0, 1e-12], [True] * 4, [True, True, True, False]),
])
def test_escalation_rule(mu, plain, esc):
    ok_plain, ok_esc = judge.allowed(torch.tensor(mu, dtype=torch.float64),
                                     ESCALATING)
    assert ok_plain.tolist() == plain
    assert ok_esc.tolist() == esc


@pytest.mark.parametrize("bound,compared", [
    # lanes the reference leaves unsettled are left out...
    (1e-6, [True, False, True]),
    # ...unless the cell compares every lane
    (None, [True, True, True]),
])
def test_which_lanes_are_compared(bound, compared):
    mu = torch.tensor([1e-9, 0.1, 1e-6], dtype=torch.float64)
    assert judge.settled(mu, dict(settled_mu=bound)).tolist() == compared
