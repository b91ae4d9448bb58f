"""The ``utf16_to_utf8.mixed_64m`` cell's check on the CPU at small sizes:
a sound run passes it; the control, half of the input left out and one
output byte altered each fail it."""

import time

import pytest

from bench_torch import harness

CELL = "utf16_to_utf8.mixed_64m"
SMALL = {"doc_units": 6 * 2048, "page_units": 2048}
SECONDS = 0.3


def run(seed=2**31 + 9, **kw):
    return harness.run_cell(CELL, seed, SECONDS, False, t_start=time.perf_counter(),
                            device="cpu", traffic=SMALL, **kw)


def half_input(session):
    orig = session.entry
    session.entry = lambda x, n, be: orig(x, n // 2, be)


def altered_byte(session):
    orig = session.entry

    def entry(x, n, be):
        r = orig(x, n, be)
        r[2][5] += 1
        return r
    session.entry = entry


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["compared"]) == {"scalars_wrong", "bytes_wrong"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["compared"].values())
    assert {"gbps", "call_ms_p95", "setup_s"} <= set(r["metrics"])


def test_control_fails():
    r = run(control=True)
    assert not r["correct"]
    assert all(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("fault", [half_input, altered_byte], ids=lambda f: f.__name__)
def test_fault_fails(fault):
    r = run(patch=fault)
    assert not r["correct"], r["compared"]
    assert r["failed"] > 0


def test_needed_bytes_and_input_bytes():
    """A call needs its units read once and its bytes written once, and
    returns its input in bytes, as the UTF-8 cells do."""
    import numpy as np

    cfg = harness.load_module(harness.HERE / "configs" / "utf16_to_utf8.py",
                              "bench_torch.configs.utf16_to_utf8")
    data = np.frombuffer("aé東🙂 ".encode("utf-16-le") * 100, np.uint8).reshape(1, -1)
    s = cfg.make(data, 5, "cpu", False)
    assert s.call(0) == data.shape[1]
    assert s.needed_bytes == data.shape[1] + len("aé東🙂 ".encode() * 100)
    compared, wrong, _ = s.check()
    assert wrong == 0 and all(v == 0 for v, _ in compared.values())
