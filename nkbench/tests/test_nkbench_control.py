"""The control: the plain reference computed in bfloat16 and put in the
program's place reads not correct, while the program reads correct, on
the CPU at a tiny size and (marked `gpu`) on the card at a reduced one."""

import pytest

import harness
from reference.check import verdict

NAMES = ["film-1e6"]


def check(out, name):
    limits = harness.load_cell(name).limits
    assert out["correct"] is True
    assert not verdict(out["control"], limits)
    return [k for k in limits if out["control"][k] > limits[k]]


@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_on_the_cpu(name):
    import torch

    torch.set_num_threads(2)
    out = harness.run_cell(name, 23, 0.5, False, device="cpu", mesh=6, particles=8000,
                           control=True, log=lambda *a, **k: None)
    assert check(out, name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_on_the_card(card, name):
    out = harness.run_cell(name, 29, 1.0, False, device=card, particles=200000, control=True,
                           log=lambda *a, **k: None)
    assert check(out, name)
