"""The ranks `--n_shards` starts (nanokappa_torch/parallel/launch.py
shard_count): 0, the default, is one rank on any number of cards, as the
JAX driver runs one device (nanokappa_tpu/driver.py:149, `n_shards or 1`);
a positive count is that many ranks, one a card, and more ranks than
visible cards are refused. The card count is monkeypatched: no card is
needed."""

import pytest


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_zero_shards_is_one_rank_on_any_card_count(monkeypatch, cards):
    import torch

    from nanokappa_torch.parallel.launch import shard_count

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert shard_count(0, "cuda") == 1
    assert shard_count(0, "cuda:0") == 1
    assert shard_count(1, "cuda") == 1


@pytest.mark.parametrize("cards", [2, 4])
def test_positive_shards_take_one_card_each(monkeypatch, cards):
    import torch

    from nanokappa_torch.parallel.launch import shard_count

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert shard_count(2, "cuda") == 2
    assert shard_count(cards, "cuda") == cards


@pytest.mark.parametrize("shards, cards", [(4, 2), (2, 1), (8, 4)])
def test_more_shards_than_cards_raise(monkeypatch, shards, cards):
    import torch

    from nanokappa_torch.parallel.launch import shard_count

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=f"--n_shards {shards} needs {shards} CUDA cards"):
        shard_count(shards, "cuda")


@pytest.mark.parametrize("shards, ranks", [(0, 1), (1, 1), (3, 3)])
def test_cpu_ranks_need_no_card(monkeypatch, shards, ranks):
    import torch

    from nanokappa_torch.parallel.launch import shard_count

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert shard_count(shards, "cpu") == ranks


def test_the_cli_help_says_zero_is_one_rank():
    from nanokappa_torch.io.config import initialise_parser, read_args

    args = read_args(["-pf", "POSCAR", "-hf", "x.hdf5"])
    assert int(args.n_shards[0]) == 0
    flag = next(a for a in initialise_parser()._actions if "--n_shards" in a.option_strings)
    assert "0 = one rank" in flag.help and "every visible card" not in flag.help
