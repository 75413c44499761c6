"""Byte-exact serde_json-compatible pretty JSON emission.

The reference writes results with ``serde_json::to_string_pretty`` plus a
trailing newline (exporters.rs:14-24). Field order is struct declaration
order; floats are f32 rendered by Ryu (shortest round-trip). This module
reproduces that byte stream from plain Python objects.
"""

from __future__ import annotations

import numpy as np

_ESCAPES = {
    '"': '\\"',
    "\\": "\\\\",
    "\b": "\\b",
    "\f": "\\f",
    "\n": "\\n",
    "\r": "\\r",
    "\t": "\\t",
}


class F32(float):
    """Marker: serialize this float as an f32 (shortest Ryu repr)."""


def escape_string(s: str) -> str:
    out = []
    for ch in s:
        if ch in _ESCAPES:
            out.append(_ESCAPES[ch])
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def format_f32(v: float) -> str:
    """Shortest decimal that round-trips through f32, in Ryu/serde_json style.

    serde_json prints finite f32 via ryu::Buffer::format_finite: fixed
    notation with a mandatory fractional part (``0.0``, ``98.76543``),
    switching to exponent notation (``1e20``, ``1.5e-9``) outside the
    fixed-notation range.
    """
    v32 = np.float32(v)
    if np.isnan(v32) or np.isinf(v32):
        raise ValueError("non-finite f32 cannot be serialized to JSON")
    if v32 == 0.0:
        return "-0.0" if np.signbit(v32) else "0.0"

    # shortest significant-digit count that round-trips through f32
    for prec in range(1, 10):
        s = np.format_float_scientific(
            v32, precision=prec - 1, unique=False, trim="-")
        if np.float32(s) == v32:
            break
    # s is like "d.dddde±EE"; convert to ryu conventions
    mant, exp = s.split("e")
    exp = int(exp)
    neg = mant.startswith("-")
    if neg:
        mant = mant[1:]
    digits = mant.replace(".", "").rstrip("0") or "0"
    ndig = len(digits)
    # ryu (d2s/f2s) uses fixed notation when -6 <= e10 < 21 where the
    # printed value is digits * 10^(exp - ndig + 1)
    e10 = exp  # exponent of the leading digit
    if -5 <= e10 <= 15:
        # fixed notation
        point = e10 + 1  # digits before the decimal point
        if point <= 0:
            body = "0." + "0" * (-point) + digits
        elif point >= ndig:
            body = digits + "0" * (point - ndig) + ".0"
        else:
            body = digits[:point] + "." + digits[point:]
    else:
        if ndig == 1:
            mantissa = digits
        else:
            mantissa = digits[0] + "." + digits[1:]
        body = f"{mantissa}e{e10}"
    return ("-" if neg else "") + body


def _write(obj, indent: int, out: list):
    pad = "  " * indent
    if obj is None:
        out.append("null")
    elif obj is True:
        out.append("true")
    elif obj is False:
        out.append("false")
    elif isinstance(obj, F32):
        out.append(format_f32(obj))
    elif isinstance(obj, float):
        # plain f64; not used by the result schema but supported
        out.append(repr(obj))
    elif isinstance(obj, (int, np.integer)):
        out.append(str(int(obj)))
    elif isinstance(obj, str):
        out.append('"' + escape_string(obj) + '"')
    elif isinstance(obj, dict):
        if not obj:
            out.append("{}")
            return
        out.append("{\n")
        items = list(obj.items())
        for i, (k, v) in enumerate(items):
            out.append(pad + "  " + '"' + escape_string(k) + '": ')
            _write(v, indent + 1, out)
            out.append(",\n" if i + 1 < len(items) else "\n")
        out.append(pad + "}")
    elif isinstance(obj, (list, tuple)):
        if not obj:
            out.append("[]")
            return
        out.append("[\n")
        for i, v in enumerate(obj):
            out.append(pad + "  ")
            _write(v, indent + 1, out)
            out.append(",\n" if i + 1 < len(obj) else "\n")
        out.append(pad + "]")
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def to_string_pretty(obj) -> str:
    out: list = []
    _write(obj, 0, out)
    return "".join(out)


def save_json(obj, fh) -> None:
    """serde_json::to_string_pretty + trailing newline (exporters.rs:14-24)."""
    fh.write(to_string_pretty(obj))
    fh.write("\n")
