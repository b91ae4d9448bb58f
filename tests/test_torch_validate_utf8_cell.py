"""The ``validate_utf8`` benchmark configuration on the CPU: its plain
reference against simdutf's rules, the port's validation route against
that reference on the cell's kind of text with errors planted, the
configuration's check against the control and a fault, and the route's
spans, sync, launch and chunk counts under a CPU profiler (the wrapper's
device path, with the C launch stubbed)."""

import ast
import ctypes
import random
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402
from bench_torch.configs import utf8_to_utf16_ref as codes  # noqa: E402
from bench_torch.configs import validate_utf8_ref as ref  # noqa: E402
from simdutf_tpu_torch import impl, trace  # noqa: E402
from simdutf_tpu_torch.kernels import _build  # noqa: E402
from simdutf_tpu_torch.kernels import validate as kv  # noqa: E402
from simdutf_tpu_torch.ops import utf8 as o8  # noqa: E402

text = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
CELL = "validate_utf8.mixed_64m"
TRAFFIC = harness.load_cell(CELL).traffic
SMALL = {"doc_bytes": 48000, "page_bytes": 4000}
SECONDS = 0.3

VALID = "aé Жм東🙂 x\U0010ffff😀"
BAD = [  # (bad sequence, simdutf's code), each invalid whatever follows it
    (b"\xf8", codes.HEADER_BITS),
    (b"\xff", codes.HEADER_BITS),
    (b"\xc3", codes.TOO_SHORT),
    (b"\xe6\x9d", codes.TOO_SHORT),
    (b"\xf0\x9f\x99", codes.TOO_SHORT),
    (b"\x80", codes.TOO_LONG),
    (b"\xbf", codes.TOO_LONG),
    (b"\xc0\xaf", codes.OVERLONG),
    (b"\xe0\x80\x80", codes.OVERLONG),
    (b"\xf0\x8f\xbf\xbf", codes.OVERLONG),
    (b"\xf4\x90\x80\x80", codes.TOO_LARGE),
    (b"\xf5\x80\x80\x80", codes.TOO_LARGE),
    (b"\xed\xa0\x80", codes.SURROGATE),
    (b"\xed\xbf\xbf", codes.SURROGATE),
]


def _cases():
    out = [(VALID.encode(), ref.SUCCESS, len(VALID.encode())), (b"", ref.SUCCESS, 0)]
    for bad, code in BAD:
        for where, before in (("start", ""), ("middle", VALID[:5]), ("end", VALID)):
            after = "" if where == "end" else VALID
            out.append((before.encode() + bad + after.encode(), code, len(before.encode())))
    return out


@pytest.mark.parametrize("data,code,pos", _cases())
def test_reference_follows_simdutf_rules(data, code, pos):
    """Every UTF-8 error code at the start, middle and end of text with
    sequences of every length; (SUCCESS, length) for valid text."""
    assert ref.validate(data) == (code, pos)


def test_reference_imports_nothing_of_the_program():
    """The reference and the module whose error rules it shares import
    neither JAX, nor the JAX package, nor the port."""
    seen = set()
    for name in ("validate_utf8_ref.py", "utf8_to_utf16_ref.py"):
        tree = ast.parse((harness.HERE / "configs" / name).read_text())
        seen |= {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        seen |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert seen <= {"__future__", "numpy", "bench_torch"}
    assert not seen & {"jax", "jaxlib", "simdutf_tpu", "simdutf_tpu_torch"}


# -- the port's route on the cell's text -------------------------------------

def _staged(data: np.ndarray):
    buf, n = impl._pad(data)
    return impl.to_device(buf.copy(), n, "cpu")


def _port(data: np.ndarray):
    """(code, pos) of the port's route on the CPU, staged as the cell
    stages it."""
    x, n = _staged(data)
    code, pos = o8.validate_with_errors(x, n)
    return int(code), int(pos)


def _planted(seed: int, pages: int, page_bytes: int) -> list:
    """The cell's text at a small size, valid, and with a bad sequence
    planted at a character start drawn from ``seed``, three times, plus
    one cut sequence at the very end."""
    p = dict(TRAFFIC, docs=1, doc_bytes=pages * page_bytes, page_bytes=page_bytes)
    data = text.generate(p, seed, "cpu")[0]
    rng = random.Random(seed)
    out = [data]
    for _ in range(3):
        k = rng.randrange(len(data))
        while data[k] & 0xC0 == 0x80:
            k -= 1
        bad, _ = rng.choice(BAD)
        out.append(np.concatenate([data[:k], np.frombuffer(bad, np.uint8), data[k:]]))
    out.append(np.concatenate([data, np.frombuffer(b"\xe6\x9d", np.uint8)]))
    return out


@pytest.mark.parametrize("seed", [3, 11, 2**31 + 17])
@pytest.mark.parametrize("pages", [2, 7])
def test_port_matches_reference_on_cell_text(seed, pages):
    for data in _planted(seed, pages, 1000 + (37 * seed) % 900):
        assert _port(data) == ref.validate(data.tobytes())


# -- the configuration's check ----------------------------------------------

def run(seed=2**31 + 29, **kw):
    return harness.run_cell(CELL, seed, SECONDS, False, t_start=time.perf_counter(),
                            device="cpu", traffic=SMALL, **kw)


def shifted_pos(session):
    """Each call's position one byte on."""
    orig = session.entry
    session.entry = lambda x, n: (lambda code, pos: (code, pos + 1))(*orig(x, n))


def always_valid(session):
    """An entry that never reports an error."""
    session.entry = lambda x, n: (torch.tensor(0), torch.tensor(n))


def chunk_pos(session):
    """An error's position rounded down to its 16-byte chunk."""
    orig = session.entry

    def entry(x, n):
        code, pos = orig(x, n)
        return code, torch.where(code != 0, pos // 16 * 16, pos)
    session.entry = entry


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"] == {"scalars_wrong": {"value": 0, "limit": 0},
                             "planted_wrong": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("kw", [{"control": True}, {"patch": shifted_pos}],
                         ids=["control", "shifted_pos"])
def test_check_fails(kw):
    """The ASCII check reports TOO_LARGE at the first byte >= 0x80, and a
    position one byte on is wrong: every call's scalars are wrong."""
    r = run(**kw)
    assert not r["correct"]
    assert r["compared"]["scalars_wrong"]["value"] == r["attempted"] == r["failed"] > 0
    assert r["compared"]["planted_wrong"]["value"] == 1


@pytest.mark.parametrize("seed", [2**31 + 29, 7])
@pytest.mark.parametrize("fault", [always_valid, chunk_pos], ids=["always_valid", "chunk_pos"])
def test_planted_error_catches_faults_valid_text_hides(fault, seed):
    """An entry that never reports an error, or one that rounds an error's
    position to its chunk, answers every call on the valid traffic right;
    the call on the planted error after the window shows it."""
    r = run(seed=seed, patch=fault)
    assert not r["correct"]
    assert r["compared"] == {"scalars_wrong": {"value": 0, "limit": 0},
                             "planted_wrong": {"value": 1, "limit": 0}}


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3, 2**33 + 1])
def test_plant_site(seed):
    """A character start that does not open a 16-byte chunk, a sequence
    that fits, the same for the same seed; the planted bytes hold an
    error at the site by the reference."""
    cfg = harness.load_module(harness.HERE / "configs" / "validate_utf8.py",
                              "bench_torch.configs.validate_utf8")
    host = np.frombuffer("aé東🙂 Жм ".encode() * 50, np.uint8)
    k, bad = cfg.plant_site(host, seed)
    assert (k, bad) == cfg.plant_site(host, seed) and bad in cfg.PLANTS
    assert k % 16 and host[k] & 0xC0 != 0x80 and k + len(bad) <= len(host)
    planted = host.copy()
    planted[k:k + len(bad)] = np.frombuffer(bad, np.uint8)
    assert ref.validate(planted.tobytes())[1] == k


def test_needed_bytes_and_input_bytes():
    """A call needs its bytes read once, writes nothing, and returns its
    input bytes."""
    cfg = harness.load_module(harness.HERE / "configs" / "validate_utf8.py",
                              "bench_torch.configs.validate_utf8")
    data = np.frombuffer("aé東🙂 ".encode() * 100, np.uint8).reshape(1, -1)
    s = cfg.make(data, 5, "cpu", False)
    assert s.call(0) == s.call(1) == data.shape[1]
    assert s.needed_bytes == 2 * data.shape[1] == 2 * cfg.needed_bytes(data.shape[1])
    assert s.scalars == [(0, data.shape[1])] * 2
    s.release()
    compared, wrong, _ = s.check()
    assert wrong == 0 and compared == {"scalars_wrong": (0, 0), "planted_wrong": (0, 0)}


# -- the route's tracing ------------------------------------------------------

ROUTE = "simdutf.route.utf8.validate_with_errors"
KERNEL = "simdutf.kernel.validate.utf8_first_event_len"
SYNC = "simdutf.sync.impl.scalars"
ADDED = 7  # the exact chunks the stubbed kernel adds to the counter a launch


class _Lib:
    """Stands in for the kernels' library: the first-event kernel finds no
    error and adds ADDED to the exact-chunk counter when it is given one;
    ``launches`` records each launch's counter argument."""

    def __init__(self):
        self.launches = []

    def __getattr__(self, name):
        def entry(*args):
            assert name == "utf8_first_event"
            self.launches.append(args[3])
            if args[3] is not None:
                ctypes.c_int64.from_address(args[3]).value += ADDED
            return 0
        return entry


class _Stream:
    cuda_stream = 0


@pytest.fixture
def stubbed(monkeypatch):
    """The wrapper takes its device path on CPU tensors."""
    lib = _Lib()
    monkeypatch.setattr(_build, "_check", lambda b, length, dtype: "cuda")
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    return lib


def _call(x, n):
    """One call as the cell makes it: the route, then the one read."""
    return impl._scalars(*o8.validate_with_errors(x, n))


def _traced(x, n, calls=2):
    _call(x, n)
    with profile(activities=[ProfilerActivity.CPU]):
        got = [_call(x, n) for _ in range(calls)]
    return got, trace.snapshot()


def _data():
    return np.frombuffer(("ab cd ef gh ij kl mn op " * 4 + "é 東 🙂 Жм ").encode() * 40,
                         np.uint8)


@pytest.mark.parametrize("device_path", [False, True], ids=["plain", "stubbed_launch"])
def test_route_is_traced(request, device_path):
    """A recorded call gives its route span with the kernel wrapper's span
    inside, the one ``impl.scalars`` sync, on the device path one
    ``utf8_first_event`` launch, and the chunk counts: on the plain path
    those holding a byte the kernel's screen flags, counted by hand on text
    with two bad bytes planted (each flagged alone: it replaces an ASCII
    byte); on the device path what the kernel added to the device
    counter."""
    lib = request.getfixturevalue("stubbed") if device_path else None
    data = _data().copy()
    a = [k for k in range(len(data)) if data[k] == ord("a")]
    planted = [a[5], a[100]]
    data[planted] = 0xFF
    x, n = _staged(data)
    got, snap = _traced(x, n)
    # the stub finds no error; the plain path the first planted byte
    assert got == ([[0, len(data)]] if device_path else [[1, planted[0]]]) * 2
    spans = snap["spans"]
    assert set(spans) == {ROUTE, KERNEL, SYNC}
    assert spans[ROUTE]["parents"] == {None: 2}
    assert spans[KERNEL]["parents"] == {ROUTE: 2}
    assert spans[SYNC]["parents"] == {None: 2}
    assert snap["syncs"] == 2
    chunks = (len(data) + 15) // 16
    by_hand = len({k // 16 for k in planted})
    assert 0 < by_hand < chunks and by_hand == 2
    exact = ADDED if device_path else by_hand
    assert snap["counts"] == {kv.CHUNKS: 2 * chunks, kv.EXACT_CHUNKS: 2 * exact}
    assert snap["launches"] == ({"utf8_first_event": 2} if device_path else {})
    if device_path:
        # untraced, then twice traced on one counter
        assert lib.launches[0] is None and lib.launches[1] == lib.launches[2] is not None


def test_exact_chunks_ref_counts_in_range_bytes():
    """A chunk counts when a byte the screen flags lies before the length:
    each 0xC3 below is a lead cut short, flagged; a whole é in the last
    chunk flags nothing, and cut by the length its lead is flagged; bytes
    past the length do not count."""
    b = torch.zeros(64, dtype=torch.uint8)
    b[[3, 17, 18, 40]] = 0xC3
    b[50], b[51] = 0xC3, 0xA9
    assert kv.exact_chunks_ref(b, 64) == 3
    assert kv.exact_chunks_ref(b, 40) == 2
    assert kv.exact_chunks_ref(b, 0) == 0
    assert kv.exact_chunks_ref(b, 51) == 4
    assert kv.exact_chunks_ref(b, 52) == 3


def test_same_torch_ops_on_every_path(stubbed):
    """An untraced call and a traced one make the same torch operations
    (one fill, the key), so that tracing adds no device operation to a
    call; a recording's first call alone adds the counter's zeros."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    def ops_of_call():
        with Ops() as ops:
            o8.validate_with_errors(x, n)
        return ops.names

    x, n = _staged(_data())
    untraced = ops_of_call()
    assert untraced.count("aten::full") == 1
    with profile(activities=[ProfilerActivity.CPU]):
        assert sorted(ops_of_call()) == sorted(untraced + ["aten::zeros"])
        assert ops_of_call() == untraced
        assert ops_of_call() == untraced
    assert trace.snapshot()["counts"][kv.EXACT_CHUNKS] == 3 * ADDED
    assert stubbed.launches[0] is None and stubbed.launches[1] == stubbed.launches[3]
