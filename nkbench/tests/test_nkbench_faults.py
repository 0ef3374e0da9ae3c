"""The correctness check catches a broken timed path: a tiny run on the
CPU (past the harness's look for a card) with a fault planted in the
program underneath (faults.py) reads `correct` false, and the sound
program reads true. The narrow rounds take no particle in a tiny film's
step, so their fault is planted with kernel A's in-kernel rounds turned
off, which hands every wall event to them (the sound program reads
correct that way too)."""

import dataclasses

import pytest

import faults
import harness

# the number each fault has to push over its limit
CAUGHT_BY = {"unchanged": "step_lanes_off", "half": "datapoint_Np_off", "one_particle": "step_lanes_off",
             "injection": "inject_rows_off", "narrow": "step_lanes_off", "datapoint": "datapoint_T_gap_K"}


def run_tiny(seed=11):
    import torch

    torch.set_num_threads(2)
    return harness.run_cell("film-1e6", seed, 0.5, False, device="cpu", mesh=6, particles=8000,
                            log=lambda *a, **k: None)


@pytest.fixture
def no_kernel_rounds(monkeypatch):
    """Kernel A with no in-kernel event round: every wall event goes to the
    narrow rounds (sim/cascade.py run_event_buffer)."""
    from nanokappa_torch.ops import megastep

    real = megastep.drift_megastep_plain

    def plain(pool, T_sv, rta_on, cfg, seed=0):
        return real(pool, T_sv, rta_on, dataclasses.replace(cfg, rounds=0), seed=seed)

    monkeypatch.setattr(megastep, "drift_megastep_plain", plain)


@pytest.mark.parametrize("fault", [f for f in faults.FAULTS if f != "narrow"])
def test_a_broken_step_reads_incorrect(fault):
    with faults.plant(fault):
        out = run_tiny()
    assert out["correct"] is False
    c = out["checks"][CAUGHT_BY[fault]]
    assert c["value"] > c["limit"]


def test_broken_narrow_rounds_read_incorrect(no_kernel_rounds):
    with faults.plant("narrow"):
        out = run_tiny()
    assert out["correct"] is False
    c = out["checks"][CAUGHT_BY["narrow"]]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("seed", [11, 12])
def test_the_sound_program_reads_correct(seed):
    assert run_tiny(seed)["correct"] is True


def test_the_narrow_rounds_alone_read_correct(no_kernel_rounds):
    assert run_tiny()["correct"] is True
