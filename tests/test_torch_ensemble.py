"""Ensemble replicas of the port (nanokappa_torch/parallel/sharding.py
make_ensemble_groups, stack_ensemble_state, build_ensemble_step) on the
CPU over gloo: 2 replicas x 2 particle shards, 4 ranks spawned once, the
film at 4,000 particles a replica for 6 x 5 steps, mirroring
tests/test_sharding.py:59 (test_ensemble_mesh_independent_replicas)."""

import numpy as np
import pytest

from torch_parity import assert_same
from torch_shard_ranks import ensemble, start_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ensemble")
    start_ranks(ensemble, 4, str(out), 2, 2, 4000, 8192, 6, 5)(120)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_replicas_are_independent_chains(ranks):
    T = ranks[0]["T_sv"]
    assert T.shape == (2, 10)  # the replica axis leads
    # independent chains: same physics, different noise
    assert np.abs(T[0] - T[1]).max() > 1e-6
    assert np.abs(T[0] - T[1]).max() < 1.0
    assert np.all(T > 298.0) and np.all(T < 302.0)
    assert int(ranks[0]["lost"].sum()) == 0
    assert ranks[0]["N_p"].shape == (2,) and np.all(ranks[0]["N_p"] > 0.9 * 4000)


def test_ranks_hold_their_place_and_the_same_outputs(ranks):
    assert [(int(r["replica"]), int(r["shard"])) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for k in ("T_sv", "E_sv", "phi_sv", "Np_sv", "N_p", "lost_split", "frozen"):
            assert_same(r[k], ranks[0][k], k)
