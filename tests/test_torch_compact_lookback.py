"""Kernel C's one-launch protocol and kernel D's one-thread-a-lane loop,
emulated in numpy on the CPU (the CUDA kernels run only on the card) and
held bit for bit against the plain twins and the JAX package's Pallas
kernels (interpret mode).

Kernel C (`nanokappa_torch/csrc/compact.cu`): tiles of 256 threads x 16
mask lanes, counted from the 16-byte boundary at or below the mask's start
(`head` = its address mod 16); a tile takes its id from a ticket, ranks its
lanes by a scan of its threads' popcounts, publishes its count and then
its inclusive prefix as (flag, count) status words, and looks back over its
predecessors 32 at a time, nearest first, waiting on any word not yet
written, down to the nearest inclusive prefix. The tile with the last id
writes n_valid and the sentinel tail; the last tile to finish zeroes the
scratch. The emulation runs each tile as a generator that yields at every
access to the shared scratch and interleaves the tiles in random orders
(a tile starts only after the tiles with lower tickets), so the look-back
meets every mix of missing, aggregate and inclusive words.

Kernel D (`nanokappa_torch/csrc/scatter_rows.cu`): one thread per update
lane; an index >= N ends its thread at once (the sentinel suffix), and the
0 <= i < N test drops any other lane outside the pool.

Tolerance: none — both are data movement, bit-exact.
"""

import numpy as np
import pytest
import torch

from torch_parity import SCATTER_CASES, assert_bits, compact_cases, scatter_case

THREADS, LANES = 256, 16
TILE = THREADS * LANES
AGG, INCL = 1, 2  # status flags; 0 = not written


class Scratch:
    """The kernel's scratch: ticket, finished count, one status word a tile."""

    def __init__(self, tiles):
        self.ticket = 0
        self.done = 0
        self.status = [(0, 0)] * tiles

    def zeroed(self):
        return self.ticket == 0 and self.done == 0 and all(w == (0, 0) for w in self.status)


def tile_ranks(mask, head):
    """Per tile: the lane ids of its True lanes and their ranks within the
    tile (thread order, then bit order: a thread's exclusive prefix of
    popcounts plus the set bits below), and the tile count."""
    n = mask.shape[0]
    tiles = max(1, -(-(n + head) // TILE))
    vm = np.zeros(tiles * TILE, bool)
    vm[head : head + n] = mask
    bits = vm.reshape(tiles, THREADS, LANES)
    c = bits.sum(axis=2)
    thread_excl = np.cumsum(c, axis=1) - c
    within = np.cumsum(bits, axis=2) - bits
    rank = thread_excl[:, :, None] + within
    lane = (np.arange(tiles * TILE) - head).reshape(tiles, THREADS, LANES)
    out = [(lane[t][bits[t]], rank[t][bits[t]]) for t in range(tiles)]
    return out, c.sum(axis=1), tiles


def tile_proc(sc, tiles, lanes_ranks, agg, cap, n, out):
    """One tile's run, yielding at each access to the shared scratch."""
    t = sc.ticket
    sc.ticket += 1
    yield
    a = int(agg[t])
    if t == 0:
        sc.status[0] = (INCL, a)
        excl = 0
    else:
        sc.status[t] = (AGG, a)
        yield
        excl, j = 0, t - 1
        while True:
            ks = [j - lane for lane in range(32)]
            words = [sc.status[k] if k >= 0 else (INCL, 0) for k in ks]
            while any(f == 0 for f, _ in words):
                yield
                words = [sc.status[k] if f == 0 else (f, v) for k, (f, v) in zip(ks, words)]
            incl = [lane for lane, (f, _) in enumerate(words) if f == INCL]
            stop = incl[0] if incl else 31
            excl += sum(v for _, v in words[: stop + 1])
            if incl:
                break
            j -= 32
            yield
        sc.status[t] = (INCL, excl + a)
    yield
    lanes, rank = lanes_ranks[t]
    g = excl + rank
    keep = g < cap
    out[g[keep]] = lanes[keep]
    if t == tiles - 1:
        nv = min(excl + a, cap)
        out[nv:cap] = n
        out[cap] = nv
    yield
    sc.done += 1
    if sc.done == tiles:
        sc.status = [(0, 0)] * tiles
        sc.ticket = sc.done = 0


def emulate_compact(mask, cap, head=0, rng=None):
    """Kernel C's launch, its tiles interleaved by `rng` (None: in ticket
    order, each to its end). Returns (idx, n_valid, scratch zeroed after)."""
    lanes_ranks, agg, tiles = tile_ranks(mask, head)
    sc = Scratch(tiles)
    out = np.full(cap + 1, -7, np.int32)  # never-written lanes show
    running, started = [], 0

    def start():
        g = tile_proc(sc, tiles, lanes_ranks, agg, cap, mask.shape[0], out)
        next(g)  # takes its ticket
        running.append(g)

    while started < tiles or running:
        if rng is None:
            start()
            started += 1
            for _ in running.pop():
                pass
        elif started < tiles and (not running or rng.random() < 0.3):
            start()
            started += 1
        else:
            k = int(rng.integers(len(running)))
            try:
                next(running[k])
            except StopIteration:
                running.pop(k)
    return out[:cap], int(out[cap]), sc.zeroed()


def plain(mask, cap):
    from nanokappa_torch.ops.compact import compact_indices_plain

    idx, nv = compact_indices_plain(torch.as_tensor(mask), cap)
    return idx.numpy(), int(nv)


MASKS = compact_cases()


@pytest.mark.parametrize("name", list(MASKS))
def test_emulated_compact_matches_plain(name):
    """The protocol in ticket order and in random interleavings, at an
    aligned start and at heads 3 and 15 (a slice m[3:] of an aligned mask
    starts 3 bytes past a 16-byte boundary): the twin's output bit for bit,
    and the scratch zeroed after every call."""
    mask, cap = MASKS[name]
    ref_idx, ref_nv = plain(mask, cap)
    rng = np.random.default_rng(len(mask))
    big = mask.shape[0] > 100_000
    orders = [None] + [rng] * (2 if big else 6)
    for head in (0, 3, 15):
        for order in orders:
            idx, nv, zeroed = emulate_compact(mask, cap, head, order)
            np.testing.assert_array_equal(idx, ref_idx)
            assert nv == ref_nv and zeroed


def test_lookback_under_random_orders():
    """50 random tile interleavings over 40 tiles (several look-back windows,
    sparse and dense tiles, count > cap): every one gives the twin's output
    and leaves the scratch zeroed."""
    rng = np.random.default_rng(50)
    p = np.repeat(rng.choice([0.0, 0.01, 0.5, 1.0], 40), TILE)
    mask = rng.random(40 * TILE - 9) < p[: 40 * TILE - 9]
    cap = int(mask.sum()) * 3 // 4
    ref_idx, ref_nv = plain(mask, cap)
    for k in range(50):
        idx, nv, zeroed = emulate_compact(mask, cap, head=k % 16, rng=np.random.default_rng(k))
        np.testing.assert_array_equal(idx, ref_idx)
        assert nv == ref_nv and zeroed


@pytest.mark.parametrize("name", [k for k, (m, _) in MASKS.items() if m.shape[0] <= 40_000])
def test_emulated_compact_matches_pallas(name):
    """At n <= 40,000: the emulation equals compact_indices_pallas
    (interpret mode), as tests/test_torch_compact.py runs it."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact import compact_indices_pallas

    mask, cap = MASKS[name]
    ji, jn = compact_indices_pallas(jnp.asarray(mask), cap, interpret=True)
    idx, nv, _ = emulate_compact(mask, cap, head=3, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    assert nv == int(jn)


def test_compact_wrapper_cpu_is_the_twin():
    """A CPU mask takes the twin (no launch), contiguous slices included."""
    from nanokappa_torch.ops import compact

    m = torch.as_tensor(MASKS["n=4097"][0])
    before = compact.launches
    idx, nv = compact.compact_indices(m[3:], 1024)
    ref_idx, ref_nv = plain(MASKS["n=4097"][0][3:], 1024)
    assert compact.launches == before
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert int(nv) == ref_nv


# --------------------------------------------------------------------------
# kernel D: one thread a lane, the sentinel-suffix exit
# --------------------------------------------------------------------------


def emulate_scatter(pool, rows, idx):
    """Kernel D's threads, one an update lane, on a copy of the pool; also
    returns the indices of the threads that left at once (index >= N),
    which the ascending order makes the sentinel suffix."""
    C, N = pool.shape
    out = pool.copy()
    live = idx < N
    gone = np.flatnonzero(~live)
    assert gone.size == 0 or gone[0] == idx.shape[0] - gone.size  # a suffix
    e = np.flatnonzero(live & (idx >= 0))  # the per-lane 0 <= i < N test
    ov, rv = out.view(np.uint32), rows.view(np.uint32)
    for c in range(C):
        ov[c, idx[e]] = rv[c, e]
    return out, idx[gone]


@pytest.mark.parametrize("n,e,nval", SCATTER_CASES + [(50_001, 2047, 1500)],
                         ids=["blocks_sentinel", "one_block", "none", "cluster", "odd_e"])
def test_emulated_scatter_matches_twin_and_pallas(n, e, nval):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.scatter_rows import scatter_rows_sorted
    from nanokappa_torch.ops.scatter_rows import scatter_rows_plain

    pool, rows, idx = scatter_case(n, e, nval)
    got, gone = emulate_scatter(pool, rows, idx)
    assert gone.size == e - nval  # exactly the sentinel tail's threads left at once
    ref = scatter_rows_plain(torch.as_tensor(pool.copy()), torch.as_tensor(rows), torch.as_tensor(idx))
    assert_bits(got, ref)
    base, upd, ix = jnp.asarray(pool.T), jnp.asarray(rows.T), jnp.asarray(idx)
    assert_bits(got, np.asarray(scatter_rows_sorted(base, upd, ix, interpret=True)).T)
