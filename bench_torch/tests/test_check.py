"""The check that decides ``correct``: sound runs of the program pass it;
the control and each fault a cell can have fail it. The harness's look for
a card is skipped: the runs are on the CPU, where each kernel runs its
plain torch version, at sizes a test run holds."""

import time

import pytest
import torch

from bench_torch import harness

SMALL = {
    "utf8_to_utf16.mixed_64m": {"doc_bytes": 48000, "page_bytes": 4000},
    "utf8_to_utf16.ascii_64m": {"doc_bytes": 40000},
    "base64_mime.decode_48m": {"raw_bytes": 30000},
}
SECONDS = 0.3


def run(cell, seed=2**31 + 7, **kw):
    return harness.run_cell(cell, seed, SECONDS, False, t_start=time.perf_counter(),
                            device="cpu", traffic=SMALL[cell], **kw)


def half_input(session):
    """Half of each call's input left out."""
    orig = session.entry
    if hasattr(session, "url"):
        session.entry = lambda x, n, url, both: orig(x, n // 2, url=url, both=both)
    else:
        session.entry = lambda x, n, be: orig(x, n // 2, be)


def altered_answer(session):
    """One unit of each call's output altered where the entry makes it."""
    orig = session.entry
    if hasattr(session, "url"):
        def entry(x, n, url, both):
            r = orig(x, n, url=url, both=both)
            r[3][5] += 1
            return r
    else:
        def entry(x, n, be):
            r = orig(x, n, be)
            r[2].view(torch.int16)[5] += 1
            return r
    session.entry = entry


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["compared"].values())
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    r = run(cell, control=True)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("fault", [half_input, altered_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_fails(cell, fault):
    r = run(cell, patch=fault)
    assert not r["correct"], r["compared"]
    assert r["failed"] > 0


def test_raising_call_fails():
    def boom(session):
        def entry(*a, **k):
            raise RuntimeError("planted")
        session.entry = entry
    with pytest.raises(RuntimeError):  # the warm-up meets it first
        run("utf8_to_utf16.mixed_64m", patch=boom)
