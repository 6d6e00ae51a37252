"""The port's msgpack codec reads and writes the common record shapes (maps
of str keys with float64 or str values) on a fast path; every byte stays
``msgpack.packb``'s and every value ``msgpack.unpackb``'s, at the nesting
limit too."""

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from shodh_tpu_torch.storage import serialization as ser

_TERMS = st.dictionaries(st.text(max_size=40), st.floats(allow_nan=False) | st.text(max_size=3)
                         | st.integers(-5, 5) | st.none(), max_size=40)


@settings(max_examples=300, deadline=None)
@given(st.lists(_TERMS, max_size=3) | _TERMS | st.dictionaries(st.text(max_size=3), _TERMS))
def test_term_maps_match_msgpack(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert ser.packb(obj) == raw
    assert ser.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


@pytest.mark.parametrize("depth", [509, 510, 511, 512])
def test_nesting_limit_on_the_fast_path(depth):
    obj = {"w": 0.5, "s": "x"}
    for _ in range(depth):
        obj = {"k": obj}
    try:
        raw = msgpack.packb(obj, use_bin_type=True)
    except ValueError:
        with pytest.raises(ValueError, match="recursion limit"):
            ser.packb(obj)
        return
    assert ser.packb(obj) == raw
    assert ser.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


@pytest.mark.parametrize("raw", [b"\x81\xa3ab", b"\x81\xa1a\xcb\x3f\xf0", b"\x82\xa1a\xcb"
                                 + b"\x00" * 8 + b"\xa2b"])
def test_truncated_maps_raise(raw):
    with pytest.raises(ValueError):
        msgpack.unpackb(raw, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        ser.unpackb(raw)
