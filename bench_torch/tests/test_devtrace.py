"""The trace reduction on hand-made events."""

from bench_torch import devtrace
from bench_torch.harness import CALL_RANGE, WINDOW_RANGE


def test_merge_and_gaps():
    m = devtrace.merge([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert m == [[0, 3], [5, 9]]
    assert devtrace.gaps(m, 0, 12) == [(3, 5), (9, 12)]
    assert devtrace.gaps(m, 1, 6) == [(3, 5)]


def test_reduce_events():
    ev = [  # name, start, end, on device
        (WINDOW_RANGE, 0, 1000, False),
        (CALL_RANGE, 0, 500, False),
        ("aten::empty", 10, 90, False),
        ("cudaLaunchKernel", 100, 120, False),
        (CALL_RANGE, 500, 1000, False),
        ("k1", 110, 300, True),
        ("k1", 600, 800, True),
        ("Memcpy DtoH", 250, 400, True),
    ]
    t = devtrace.reduce_events(ev, WINDOW_RANGE, CALL_RANGE)
    assert t.calls == 2 and t.device_ops == 3
    assert t.busy_s == (290 + 200) / 1e9 and t.window_s == 1000 / 1e9
    assert t.top_ops[0][0] == "k1" and abs(t.top_ops[0][1] - 390e-9) < 1e-15
    gaps = dict(t.top_gaps)  # [0,110): aten::empty at 55; [400,600): call; [800,1000)
    assert abs(gaps["aten::empty"] - 110e-9) < 1e-15
    assert abs(gaps[f"{CALL_RANGE} (python)"] - 400e-9) < 1e-15
