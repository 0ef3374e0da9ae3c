"""Kernel A's per-block segment sums (csrc/scan.cuh block_segment_sums),
proved on the CPU with an emulation of the kernel's counting sort in numpy
integers and float32 scalars:

  * per warp, the lanes of each segment and each lane's rank among them
    (__match_any_sync), the warps' counts turned into their exclusive
    prefix, a scan of the segments' totals, the lane ids scattered to their
    places; each output then adds its segment's run from 0.0f. The float32
    partials are bit-equal to the thread-order loop the kernel had (every
    output adds, over all 256 lanes in thread order, the lanes of its
    segment) on random segments, with segments absent, all lanes in one
    segment, seg = -1 lanes, and nseg 8, 16 and 256 (and the kernel's cap);
  * the order is a stable sort: each segment's run holds its lanes in
    thread order, and a warp's prefix fits the byte the kernel keeps it in;
  * the centre table padded for kernel A's eight-a-step loop keeps the
    first nearest real centre.
"""

import numpy as np
import pytest

BLOCK, WARP, SEG_MAX = 256, 32, 512


def loop_sums(seg, v, nseg):
    """The thread-order loop: output (s, k) adds v[k][j] for j = 0..255
    with seg[j] == s, from 0.0f."""
    out = np.zeros((nseg, 5), np.float32)
    for j in range(BLOCK):
        if 0 <= seg[j] < nseg:
            out[seg[j]] = out[seg[j]] + v[:, j]  # float32 vector add: one rounding each
    return out


def sort_order(seg, nseg):
    """The kernel's counting sort: (offsets (nseg + 1,), order (n,) of lane
    ids, the per-warp exclusive prefixes (warps, nseg))."""
    has = (seg >= 0) & (seg < nseg)
    wc = np.zeros((BLOCK // WARP, SEG_MAX), np.int64)
    rank = np.zeros(BLOCK, np.int64)
    for w in range(BLOCK // WARP):
        lanes = np.arange(w * WARP, (w + 1) * WARP)
        for ln in lanes:
            key = seg[ln] if has[ln] else -1
            peers = lanes[np.where(has[lanes], seg[lanes], -1) == key]  # __match_any_sync
            rank[ln] = int((peers < ln).sum())
            if has[ln] and rank[ln] == 0:
                wc[w, seg[ln]] = len(peers)
    prefix = np.zeros_like(wc)
    tot = np.zeros(2 * BLOCK, np.int64)
    for s in range(nseg):  # thread s // 2 walks the warps of segments 2t, 2t + 1
        acc = 0
        for w in range(BLOCK // WARP):
            prefix[w, s] = acc
            acc += wc[w, s]
        tot[s] = acc
    pair = tot[0::2] + tot[1::2]  # the block scan over threads
    incl = np.cumsum(pair)
    excl = incl - pair
    off = np.zeros(nseg + 1, np.int64)
    for t in range(BLOCK):
        if 2 * t < nseg:
            off[2 * t] = excl[t]
        if 2 * t + 1 < nseg:
            off[2 * t + 1] = excl[t] + tot[2 * t]
    off[nseg] = incl[-1]
    order = np.full(BLOCK, -1, np.int64)
    for ln in np.nonzero(has)[0]:
        order[off[seg[ln]] + prefix[ln // WARP, seg[ln]] + rank[ln]] = ln
    return off, order[: off[nseg]], prefix


def sorted_sums(seg, v, nseg):
    """Each output adds its own run of the sorted lanes, from 0.0f."""
    off, order, _ = sort_order(seg, nseg)
    out = np.zeros((nseg, 5), np.float32)
    if len(order) == 0:
        return out  # the block without a contributing lane writes zeros
    for s in range(nseg):
        acc = np.zeros(5, np.float32)
        for j in range(off[s], off[s + 1]):
            acc = acc + v[:, order[j]]
        out[s] = acc
    return out


def _blocks(nseg, rng):
    """Segment patterns: random, sparse (most segments absent), one
    segment, seg = -1 lanes, runs of neighbours (the sorted pool), and
    no contributing lane."""
    yield rng.integers(0, nseg, BLOCK)
    yield np.where(rng.random(BLOCK) < 0.3, rng.integers(0, nseg, BLOCK), -1)
    yield rng.choice(rng.integers(0, nseg, 3), BLOCK)
    yield np.full(BLOCK, rng.integers(0, nseg))
    yield np.sort(rng.integers(0, nseg, BLOCK))
    yield np.full(BLOCK, -1)


def _values(rng):
    """Signed energies over six decades (cancellation), the velocity
    products and the count column."""
    e = rng.normal(0.0, 1.0, BLOCK) * 10.0 ** rng.uniform(-3, 3, BLOCK)
    vel = rng.normal(0.0, 3e3, (3, BLOCK))
    return np.concatenate([e[None], e[None] * vel, np.ones((1, BLOCK))]).astype(np.float32)


@pytest.mark.parametrize("nseg", [8, 16, 256, SEG_MAX])
def test_sorted_sums_bit_equal_to_the_loop(nseg):
    rng = np.random.default_rng(nseg)
    n = 0
    for _ in range(6):
        for seg in _blocks(nseg, rng):
            v = _values(rng)
            a, b = sorted_sums(seg, v, nseg), loop_sums(seg, v, nseg)
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), (nseg, seg[:16])
            n += 1
    assert n == 36


def test_order_is_stable_and_fits_a_byte():
    rng = np.random.default_rng(11)
    for nseg in (8, 16, 256):
        for seg in _blocks(nseg, rng):
            off, order, prefix = sort_order(seg, nseg)
            has = (seg >= 0) & (seg < nseg)
            want = np.nonzero(has)[0]
            want = want[np.argsort(seg[want], kind="stable")]
            assert np.array_equal(order, want)  # by segment, then thread order
            assert np.array_equal(np.diff(off), np.bincount(seg[has], minlength=nseg)[:nseg])
            assert prefix.max() <= (BLOCK // WARP - 1) * WARP <= 255


@pytest.mark.parametrize("n", [1, 8, 13, 250, 256])
def test_padded_centres_keep_the_first_nearest(n):
    """Kernel A walks the centre table eight rows a step, padded with rows
    [0, 0, 0, +inf] (ops/megastep.py _pad_centers): a padding row's key is
    +inf or NaN and never beats the running minimum, so the first nearest
    real centre wins as on the unpadded table — also for positions whose
    keys are all +inf, NaN or tied."""
    import torch

    from nanokappa_torch.ops.megastep import _pad_centers

    rng = np.random.default_rng(n)
    c = torch.as_tensor(rng.uniform(-500.0, 500.0, (n, 3)), dtype=torch.float32)
    c2 = (c.double() ** 2).sum(1).float()
    if n > 4:
        c[3], c2[3] = c[1], c2[1]  # an exact duplicate: the tie goes to 1
    table = torch.cat([c, c2[:, None]], 1)
    pad = _pad_centers(table)
    assert pad.shape == (max(8, -(-n // 8) * 8), 4) and torch.equal(pad[:n], table)
    assert bool((pad[n:, :3] == 0).all()) and bool(torch.isinf(pad[n:, 3]).all())
    q = torch.as_tensor(rng.uniform(-600.0, 600.0, (400, 3)), dtype=torch.float32)
    q[0] = float("nan")
    q[1] = torch.tensor([3e38, 3e38, 3e38])
    if n > 4:
        q[2] = c[1]

    def first_nearest(tab):  # the kernel's loop: strict < from +inf, in order
        dot = (q[:, 0:1] * tab[None, :, 0] + q[:, 1:2] * tab[None, :, 1]) + q[:, 2:3] * tab[None, :, 2]
        d = tab[None, :, 3] - 2.0 * dot
        best = torch.zeros(q.shape[0], dtype=torch.long)
        bd = torch.full((q.shape[0],), float("inf"))
        for k in range(tab.shape[0]):
            win = d[:, k] < bd
            bd = torch.where(win, d[:, k], bd)
            best = torch.where(win, k, best)
        return best

    from nanokappa_torch.sim.binning import nearest_center

    a, b = first_nearest(pad), first_nearest(table)
    assert torch.equal(a, b) and int(a.max()) < n
    assert torch.equal(a.to(torch.int32), nearest_center(q, c, c2))  # the twin's classifier
    if n > 4:
        assert int(a[2]) == 1
