"""The port stands alone: no file of it imports jax or the JAX package.

Every ``.py`` under ``simdutf_tpu_torch/`` and ``chip_smoke.py`` is parsed
with ``ast``, and any import of a ``jax*`` module or of ``simdutf_tpu`` (at
any depth of the file) fails. Then, in a fresh process, every public
function of ``simdutf_tpu_torch.api`` runs on ``"cpu"``, and so do
``TorchPallasImplementation("cpu")``'s ``internal_tests`` and the methods
it overrides; no module of those names may be loaded afterwards.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import simdutf_tpu_torch
from simdutf_tpu_torch import api

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("simdutf_tpu",)  # and every module whose name starts with jax
SOURCES = sorted((ROOT / "simdutf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    """(line, absolute module name) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imports(path)
           if mod.split(".")[0].startswith("jax") or mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_implementation_has_no_base_class_from_the_jax_package():
    bases = simdutf_tpu_torch.TorchImplementation.__mro__[1:]
    assert bases == (object,)


def _public_functions():
    return sorted(name for name, obj in vars(api).items()
                  if callable(obj) and not name.startswith("_")
                  and getattr(obj, "__module__", None) == api.__name__
                  and not isinstance(obj, type))


_DRIVER = r'''
import sys
import numpy as np
from simdutf_tpu_torch import api

api.use_device("cpu")
text = "a é 東 \U0001f642 " * 50
inputs = {"utf8": text.encode(), "utf16le": text.encode("utf-16-le"),
          "utf16be": text.encode("utf-16-be"), "utf16": text.encode("utf-16-le"),
          "utf32": text.encode("utf-32-le"), "latin1": text.encode(),
          "ascii": b"plain ascii", "encoding": text.encode("utf-16-le"),
          "encodings": text.encode("utf-32-le")}

def source(name):
    if name.startswith("convert_"):
        return name.split("_to_")[0].split("_")[-1]
    if "_from_" in name:
        return name.split("_from_")[1]
    if name.startswith(("change_endianness_", "to_well_formed_", "trim_partial_")):
        return name.split("_")[-1]
    return name.split("_")[1]

called = []
for name in NAMES:
    fn = getattr(api, name)
    if name in ("use_device", "get_implementation"):
        fn("cpu") if name == "use_device" else fn()
    elif name == "base64_length_from_binary":
        assert fn(10) == 16
    elif name in ("latin1_length_from_utf16", "latin1_length_from_utf32",
                  "utf16_length_from_latin1", "utf32_length_from_latin1"):
        assert fn(10) == 10
    elif name.endswith("base64_to_binary_safe"):
        res, out = fn(__import__("base64").b64encode(inputs["utf8"]), 64)
        assert len(out) == 63 and res.error == 10  # OUTPUT_BUFFER_TOO_SMALL
    elif name.endswith("_safe"):
        assert len(fn(inputs[source(name)], 64)) <= 64
    elif "base64" in name:
        b64 = __import__("base64").b64encode(inputs["utf8"])
        arg = inputs["utf8"] if name.startswith("binary_to") else b64
        fn(arg)
    elif name.endswith("_into"):
        assert fn(inputs[source(name)], np.zeros(1 << 16, np.uint32)) > 0
    else:
        fn(inputs[source(name)])
    called.append(name)
assert called == NAMES
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "simdutf_tpu")
assert not bad, bad
print(len(called))
'''


def test_every_api_function_runs_without_jax_or_the_jax_package():
    names = _public_functions()
    assert len(names) > 50
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", f"NAMES = {names!r}\n" + _DRIVER],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == str(len(names))


_PALLAS_SCRIPT = r'''
import base64
import sys
import numpy as np
from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

impl = TorchPallasImplementation("cpu")
for name, check in impl.internal_tests():
    check()
text = "a é 東 \U0001f642 " * 50
b = np.frombuffer(text.encode() + b"\xff", np.uint8)
w = np.frombuffer(text.encode("utf-16-le"), np.uint16)
assert impl.validate_utf8_with_errors(b) == (1, len(b) - 1) and not impl.validate_utf8(b)
assert impl.validate_ascii_with_errors(b) == (5, 2) and not impl.validate_ascii(b)
assert impl.validate_utf16le(w) and impl.validate_utf16be_with_errors(w.byteswap()) == (0, len(w))
h = w[:-2]  # the last pair cut after its high surrogate
assert not impl.validate_utf16le(h) and not impl.validate_utf16be(h.byteswap())
assert impl.validate_utf16le_with_errors(h) == (6, len(h) - 1)
a = np.frombuffer(b"ascii", np.uint8)
assert impl.convert_valid_utf8_to_latin1(a).tobytes() == b"ascii"
assert impl.convert_utf8_to_latin1_with_errors(a)[1].tobytes() == b"ascii"
full, out = impl.base64_to_binary_details(np.frombuffer(base64.b64encode(b"hello"), np.uint8))
assert full.is_ok and out.tobytes() == b"hello"
assert impl.safety_net == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "simdutf_tpu")
assert not bad, bad
print("ok")
'''


def test_pallas_tier_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"
