"""The C entry points of ``src/repro_torch/kernels/csrc/*.cu`` against the
ctypes signatures ``kernels/cuda.py`` gives them (``_SIGS``).

ctypes trusts ``argtypes``: a signature that drifts from the source (an
argument added, dropped or moved, an int where a pointer goes) passes
pointers as ints or shifts every later argument, and on the card that is
a crash or silent garbage. The CPU cannot build or launch the kernels, so
this test reads the sources instead: every ``extern "C"`` entry point, its
return type (int, the CUDA error), the number of its parameters and the
kind of each (pointer, int, float, long long) must match ``_SIGS`` and the
library ``_LIB_OF`` loads it from.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import cuda as tcuda

_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float,
          "long long": ctypes.c_longlong}
_ENTRY = re.compile(r"^(\w[\w ]*?)\s+(\w+)\s*\(([^)]*)\)\s*\{", re.M)


def _kind(param: str):
    """The ctypes type of one C parameter (`const void* q`, `int B`)."""
    text = " ".join(param.split())
    if "*" in text:
        return ctypes.c_void_p
    ctype = text.rsplit(" ", 1)[0].replace("const ", "")
    if ctype not in _KINDS:
        raise AssertionError(f"no ctypes kind for C parameter {param!r}")
    return _KINDS[ctype]


def _entry_points(source: str):
    """{name: (return type, [ctypes kind of each parameter])} of the
    functions defined inside the source's extern "C" blocks."""
    text = (build.CSRC / source).read_text()
    found = {}
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text,
                            re.S):
        block = re.sub(r"//[^\n]*", "", block)
        for ret, name, params in _ENTRY.findall(block):
            found[name] = (ret.strip(), [_kind(p) for p in params.split(",")])
    return found


def test_every_entry_point_has_a_signature():
    defined = {}
    for lib, source in build.SOURCES.items():
        points = _entry_points(source)
        assert points, f"{source} defines no extern \"C\" entry point"
        for name in points:
            defined[name] = lib
    assert defined == tcuda._LIB_OF
    assert set(tcuda._SIGS) == set(tcuda._LIB_OF)


@pytest.mark.parametrize("name", sorted(tcuda._SIGS))
def test_signature_matches_source(name):
    source = build.SOURCES[tcuda._LIB_OF[name]]
    points = _entry_points(source)
    assert name in points, f"{name} is not an entry point of {source}"
    ret, kinds = points[name]
    assert ret == "int"                 # the wrappers read a CUDA error
    sig = tcuda._SIGS[name]
    assert len(kinds) == len(sig), (name, len(kinds), len(sig))
    for i, (c, py) in enumerate(zip(kinds, sig)):
        assert c is py, f"{name}: parameter {i} is {c.__name__} in " \
                        f"{source} but {py.__name__} in _SIGS"
