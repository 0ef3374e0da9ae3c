"""The roofline yardstick against hand-worked shapes, and the trace
reduction (busy time as a union, kernels attributed to their call)."""

import pytest

import roofline
from trace_reader import Trace, kernel_name


def test_kernel_a_bytes_by_hand():
    # slim film: 18 rows, 1,000,000 alive lanes, 2,000 exported, 10 slices
    # (16 padded rows of sums) + 8 ledger rows of 5 floats
    want = 2 * 18 * 4 * 1_000_000 + 2_000 * (18 * 4 + 4) + (16 + 8) * 5 * 4
    assert roofline.kernel_a_bytes(18, 1_000_000, 2_000, 10) == want == 144_152_480
    # plain wire pool: 16 rows, 5 slices (8 padded rows)
    assert roofline.kernel_a_bytes(16, 10, 1, 5) == 2 * 16 * 4 * 10 + 68 + 16 * 20


def test_kernel_a_ops_and_bound():
    assert roofline.kernel_a_ops(1e6, 1e4, 48) == 150e6 + 45 * 48 * 1e4
    t, by = roofline.least_seconds(144_152_480, 150e6)
    assert by == "bytes" and t == pytest.approx(144_152_480 / 3.35e12)
    t, by = roofline.least_seconds(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)
    # 0.0954 ms for the film's launch: ~45% of its roofline
    assert roofline.share_percent(144_152_480, 150e6, 0.0954e-3) == pytest.approx(45.1, abs=0.1)
    assert roofline.share_percent(1.0, 0.0, 0.0) is None


def test_kernel_b_bytes_by_hand():
    assert roofline.kernel_b_bytes(18, 1_000_000) == 2 * 18 * 4 * 1_000_000 + 4 * 1_000_000
    assert roofline.sv8(5) == 8 and roofline.sv8(10) == 16 and roofline.sv8(16) == 16


def test_kernel_names():
    assert kernel_name("void (anonymous namespace)::mega_lanes<true, 1, false, 0>(MegaCfg, float*)") == "mega_lanes"
    assert kernel_name("void nk::scan_runs(int const*, int, int*, int*, int, int*)") == "scan_runs"


def test_busy_union_gaps_and_owners():
    tr = Trace(window_us=(0.0, 100.0), steps=1, launches=5,
               device=[(10.0, 20.0, "mega_lanes"), (15.0, 25.0, "Memcpy DtoH"),
                       (30.0, 31.0, "scan_runs"), (31.0, 35.0, "mega_export"),
                       (50.0, 52.0, "count_alive"), (52.0, 53.0, "scan_runs"),
                       (53.0, 60.0, "move_lanes"), (90.0, 110.0, "mega_reduce")],
               phases=[(0.0, 70.0, "device_step"), (70.0, 100.0, "write_state")],
               cpu=[(60.0, 90.0, "aten::copy_")])
    assert tr.busy_s == pytest.approx((15 + 5 + 10 + 10) * 1e-6)
    owners = {"mega_lanes": "A", "mega_export": "A", "mega_reduce": "A",
              "count_alive": "B", "move_lanes": "B", "scan_runs": None}
    got = tr.owned_kernels(owners)
    assert got["A"] == pytest.approx((10 + 1 + 4 + 20) * 1e-6)
    assert got["B"] == pytest.approx((2 + 1 + 7) * 1e-6)
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "write_state/aten::copy_" and gaps[0][1] == pytest.approx(30e-6)
    assert tr.top_device_ops(1) == [["mega_reduce", pytest.approx(20e-6)]]
