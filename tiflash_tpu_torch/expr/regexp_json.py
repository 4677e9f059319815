"""Regexp and JSON scalar functions over dictionary strings.

A copy of ``tiflash_tpu/expr/regexp_json.py`` (pure Python: it imports
only ``base64``, ``json``, ``re`` and ``typing``, and the port's own
``runtime.errors`` and ``core.dtypes``), kept here so the port imports
nothing of the JAX package.  Patterns and paths are literals, so every
function is a host-side transform over the column's dictionary, applied
on the column's device as one gather (``expr/compile.py``).

Semantics follow MySQL/TiDB:
- match_type flags: i (case-insensitive), c (case-sensitive, wins over i),
  m (multi-line), n/s (dot matches newline); default case-sensitive
  (utf8mb4_bin collation).
- positions are 1-based; occurrence counts start at the pos offset.
- regexp_substr returns NULL on no match; regexp_instr returns 0.
- JSON path subset: $, .key, ."quoted key", [N]  ($[0] on a scalar is the
  scalar, as in MySQL).  Invalid JSON documents yield NULL (the reference
  raises; NULL keeps the whole-column LUT total).
"""

from __future__ import annotations

import base64
import json
import re
from typing import Any, List, Optional, Tuple


def compile_regexp(pattern: str, match_type: str = ""):
    flags = 0
    if "i" in match_type and "c" not in match_type:
        flags |= re.I
    if "m" in match_type:
        flags |= re.M
    if "n" in match_type or "s" in match_type:
        flags |= re.S
    return re.compile(pattern, flags)


def _match_iter(s: str, rx, pos: int):
    if pos < 1:
        raise ValueError("regexp position must be >= 1")
    return rx.finditer(s, pos - 1)


def regexp_like(s: str, pattern: str, match_type: str = "") -> bool:
    return compile_regexp(pattern, match_type).search(s) is not None


def regexp_instr(s: str, pattern: str, pos: int = 1, occurrence: int = 1,
                 return_option: int = 0, match_type: str = "") -> int:
    rx = compile_regexp(pattern, match_type)
    for i, m in enumerate(_match_iter(s, rx, int(pos)), start=1):
        if i == int(occurrence):
            return (m.end() + 1) if int(return_option) else (m.start() + 1)
    return 0


def regexp_substr(s: str, pattern: str, pos: int = 1, occurrence: int = 1,
                  match_type: str = "") -> Optional[str]:
    rx = compile_regexp(pattern, match_type)
    for i, m in enumerate(_match_iter(s, rx, int(pos)), start=1):
        if i == int(occurrence):
            return m.group(0)
    return None


def regexp_replace(s: str, pattern: str, repl: str, pos: int = 1,
                   occurrence: int = 0, match_type: str = "") -> str:
    """occurrence 0 = replace all matches from ``pos``.  ``repl`` is
    literal (MySQL does not support backreferences in repl)."""
    if pos < 1:
        raise ValueError("regexp position must be >= 1")
    rx = compile_regexp(pattern, match_type)
    head, tail = s[: int(pos) - 1], s[int(pos) - 1:]
    if int(occurrence) == 0:
        return head + rx.sub(lambda m: repl, tail)
    out, last, count = [], 0, 0
    for m in rx.finditer(tail):
        count += 1
        if count == int(occurrence):
            out.append(tail[last:m.start()])
            out.append(repl)
            last = m.end()
            break
    out.append(tail[last:])
    return head + "".join(out)


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

PathStep = Tuple[str, Any]  # ('key', name) | ('idx', i)


def parse_json_path(path: str) -> List[PathStep]:
    if not path.startswith("$"):
        # TiDB error 3143 text (json_length.test empty-path rejection)
        raise ValueError(
            "Invalid JSON path expression. The error is around "
            f"character position 1: {path!r}")
    i, steps = 1, []
    while i < len(path):
        c = path[i]
        if c == ".":
            i += 1
            if i < len(path) and path[i] == '"':
                j = path.index('"', i + 1)
                steps.append(("key", path[i + 1: j]))
                i = j + 1
            elif path[i:i + 1] == "*":
                steps.append(("wild_key", None))
                i += 1
            else:
                j = i
                while j < len(path) and (path[j].isalnum() or path[j] == "_"):
                    j += 1
                if j == i:
                    raise ValueError(f"bad JSON path member at {i}: {path!r}")
                steps.append(("key", path[i:j]))
                i = j
        elif c == "*" and path[i:i + 2] == "**":
            steps.append(("wild_deep", None))
            i += 2
        elif c == "[":
            j = path.index("]", i)
            body = path[i + 1: j].strip()
            if body == "*":
                steps.append(("wild_elem", None))
            else:
                steps.append(("idx", int(body)))
            i = j + 1
        else:
            raise ValueError(f"bad JSON path at {i}: {path!r}")
    return steps


_MISSING = object()


def _navigate_multi(v, steps: List[PathStep]) -> list:
    """All values addressed by ``steps`` (wildcards fan out; MySQL
    document order)."""
    cur = [v]
    for kind, k in steps:
        nxt = []
        for x in cur:
            if kind == "key":
                if isinstance(x, dict) and k in x:
                    nxt.append(x[k])
            elif kind == "idx":
                if isinstance(x, list):
                    if 0 <= k < len(x):
                        nxt.append(x[k])
                elif k == 0:
                    nxt.append(x)  # $[0] on a scalar is the scalar
            elif kind == "wild_elem":
                if isinstance(x, list):
                    nxt.extend(x)
            elif kind == "wild_key":
                if isinstance(x, dict):
                    nxt.extend(x.values())
            else:  # wild_deep '**': the value and every descendant
                stack = [x]
                while stack:
                    y = stack.pop(0)
                    nxt.append(y)
                    if isinstance(y, dict):
                        stack.extend(y.values())
                    elif isinstance(y, list):
                        stack.extend(y)
        cur = nxt
    return cur


def _json_navigate(doc: str, steps: List[PathStep]):
    """Returns the addressed value, _MISSING if absent/invalid JSON.
    With wildcard steps the result is the LIST of matches (callers wrap
    per MySQL: json_extract returns an array)."""
    try:
        v = json.loads(doc)
    except Exception:
        return _MISSING
    wild = any(kind.startswith("wild") for kind, _ in steps)
    matches = _navigate_multi(v, steps)
    if wild:
        return matches if matches else _MISSING
    return matches[0] if matches else _MISSING


def json_dumps_mysql(v: Any) -> str:
    """MySQL-style JSON text: ", " / ": " separators, utf-8 kept raw,
    object keys in BINARY-JSON order (length, then bytes —
    json_object.test '{"nil": ..., "obj": ...}')."""
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: (len(kv[0]), kv[0]))
        return "{" + ", ".join(
            f"{json.dumps(k, ensure_ascii=False)}: {json_dumps_mysql(x)}"
            for k, x in items) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(json_dumps_mysql(x) for x in v) + "]"
    return json.dumps(v, ensure_ascii=False)


def json_extract(doc: str, *paths: str) -> Optional[str]:
    """JSON_EXTRACT(doc, path[, path...]): single non-wildcard path
    yields the value; multiple paths or wildcards yield an ARRAY of all
    matches (MySQL)."""
    all_matches = []
    wild = len(paths) > 1
    for p in paths:
        steps = parse_json_path(p)
        wild = wild or any(k.startswith("wild") for k, _ in steps)
        v = _json_navigate(doc, steps)
        if v is _MISSING:
            continue
        if isinstance(v, list) and any(k.startswith("wild")
                                       for k, _ in steps):
            all_matches.extend(v)
        else:
            all_matches.append(v)
    if not all_matches:
        return None
    if not wild:
        return json_dumps_mysql(all_matches[0])
    return json_dumps_mysql(all_matches)


def json_unquote(s: str):
    """MySQL JSON_UNQUOTE: values wrapped in double quotes must parse
    as a JSON string — an invalid escape inside is a per-row runtime
    error (json_unquote.test '"hello\\ "'; TiDB error 3141).
    Unquoted values pass through (JsonBinary::unquoteStringInBuffer,
    ``TiDB/Decode/JsonBinary.cpp:769``)."""
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        try:
            v = json.loads(s)
            if isinstance(v, str):
                return v
        except Exception:
            pass
        from ..runtime.errors import EvalError

        return EvalError("Invalid JSON text: The document root must "
                         "not be followed by other values.")
    return s


def json_type(doc: str) -> Optional[str]:
    try:
        v = json.loads(doc)
    except Exception:
        return None
    if isinstance(v, dict):
        return "OBJECT"
    if isinstance(v, list):
        return "ARRAY"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "DOUBLE"
    return "NULL"


def json_valid(s: str) -> bool:
    try:
        json.loads(s)
        return True
    except Exception:
        return False


def json_length(doc: str, path: str = "$") -> Optional[int]:
    v = _json_navigate(doc, parse_json_path(path))
    if v is _MISSING:
        return None
    if isinstance(v, dict) or isinstance(v, list):
        return len(v)
    return 1


def json_depth(doc: str) -> Optional[int]:
    try:
        v = json.loads(doc)
    except Exception:
        return None

    def depth(x):
        if isinstance(x, dict):
            return 1 + max((depth(c) for c in x.values()), default=0)
        if isinstance(x, list):
            return 1 + max((depth(c) for c in x), default=0)
        return 1

    return depth(v)


def json_contains_path(doc: str, one_or_all: str, *paths) -> Optional[bool]:
    """Short-circuits in PATH ORDER (MySQL): 'all' returns 0 at the
    first absent path even if a later path is NULL; 'one' returns 1 at
    the first hit; a NULL path reached before the answer is decided
    gives NULL (json_contains_path.test)."""
    try:
        json.loads(doc)
    except Exception:
        return None
    mode = str(one_or_all).lower()
    if mode not in ("one", "all"):
        return None
    for p in paths:
        if p is None:
            return None
        try:
            steps = parse_json_path(str(p))
        except ValueError:
            return None  # malformed path (LUT probes dead entries too)
        hit = _json_navigate(doc, steps) is not _MISSING
        if mode == "all" and not hit:
            return False
        if mode == "one" and hit:
            return True
    return mode == "all"


# ---------------------------------------------------------------------------
# misc string codecs (FunctionsString.h breadth)
# ---------------------------------------------------------------------------


def to_base64(s: str) -> str:
    enc = base64.b64encode(s.encode()).decode()
    return "\n".join(enc[i: i + 76] for i in range(0, len(enc), 76))


def from_base64(s: str) -> Optional[str]:
    try:
        return base64.b64decode(s.replace("\n", ""), validate=True).decode()
    except Exception:
        return None


def unhex(s) -> Optional[str]:
    """MySQL UNHEX: hex text -> bytes (NULL for non-hex / odd length).
    Integer arguments are stringified first (UNHEX(3039) = '09').  The
    bytes decode utf-8-first (how the MySQL client renders VARBINARY)
    with latin1 as the lossless fallback; hex() encodes utf-8, so the
    round trip holds."""
    s = str(s)
    if not s or len(s) % 2:
        return None
    try:
        b = bytes.fromhex(s)
    except ValueError:
        return None
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError:
        return b.decode("latin-1")


def quote(s: str) -> str:
    out = s.replace("\\", "\\\\").replace("'", "\\'")
    out = out.replace("\0", "\\0").replace("\x1a", "\\Z")
    return "'" + out + "'"


def soundex(s: str) -> str:
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    letters = [c for c in s.upper() if c.isalpha()]
    if not letters:
        return ""
    head = letters[0]
    out, prev = [head], codes.get(head, "")
    for c in letters[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out.append(code)
        if c not in "HW":
            prev = code
    return ("".join(out) + "000")[:4] if len(out) < 4 else "".join(out)


def sha2(s: str, bits: int) -> Optional[str]:
    """MySQL SHA2(str, bits): bits in {0, 224, 256, 384, 512}; 0 = 256."""
    import hashlib

    algo = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384",
            512: "sha512"}.get(int(bits))
    if algo is None:
        return None
    return getattr(hashlib, algo)(s.encode()).hexdigest()


def is_ipv4(s: str) -> bool:
    """MySQL IS_IPV4: strict dotted-quad, no leading '+'/spaces; leading
    zeros allowed."""
    parts = s.split(".")
    if len(parts) != 4:
        return False
    for p in parts:
        if not p or len(p) > 3 or not p.isdigit() or int(p) > 255:
            return False
    return True


def is_ipv6(s: str) -> bool:
    import ipaddress

    if "%" in s:
        # python accepts zone indices ('fe80::1%24'); MySQL does not
        # (is_ip_addr.test)
        return False
    try:
        ipaddress.IPv6Address(s)
        return True
    except Exception:
        return False


def inet_aton(s: str) -> Optional[int]:
    """MySQL INET_ATON: supports short forms a.b, a.b.c (last part fills
    the remaining bytes)."""
    parts = s.split(".")
    if not 1 <= len(parts) <= 4:
        return None
    try:
        vals = [int(p) for p in parts]
    except ValueError:
        return None
    if any(v < 0 or v > 255 for v in vals[:-1]) or vals[-1] < 0:
        return None
    fill = 4 - len(parts)
    if vals[-1] >= 1 << (8 * (fill + 1)):
        return None
    acc = 0
    for v in vals[:-1]:
        acc = (acc << 8) | v
    return (acc << (8 * (fill + 1))) | vals[-1]


def json_quote(s: str) -> str:
    return json.dumps(s, ensure_ascii=False)


def json_keys(doc: str, path: str = "$") -> Optional[str]:
    v = _json_navigate(doc, parse_json_path(path))
    if v is _MISSING or not isinstance(v, dict):
        return None
    return json_dumps_mysql(list(v.keys()))


def _json_contains_value(target: Any, candidate: Any) -> bool:
    """MySQL JSON_CONTAINS containment: arrays contain each candidate
    element somewhere; objects contain all candidate key/values; scalars
    are contained by equality (an array also contains a matching scalar)."""
    if isinstance(target, list):
        if isinstance(candidate, list):
            return all(
                any(_json_contains_value(t, c) for t in target)
                for c in candidate
            )
        return any(_json_contains_value(t, candidate) for t in target)
    if isinstance(target, dict) and isinstance(candidate, dict):
        return all(
            k in target and _json_contains_value(target[k], v)
            for k, v in candidate.items()
        )
    if isinstance(target, bool) or isinstance(candidate, bool):
        return target is candidate
    if isinstance(target, (int, float)) and isinstance(candidate, (int, float)):
        return float(target) == float(candidate)
    return type(target) is type(candidate) and target == candidate


def json_contains(doc: str, candidate: str, path: str = "$") -> Optional[bool]:
    v = _json_navigate(doc, parse_json_path(path))
    if v is _MISSING:
        return None
    try:
        c = json.loads(candidate)
    except Exception:
        return None
    return _json_contains_value(v, c)


# MySQL date format specifier -> python strftime/strptime piece (the
# subset meaningful for DATE values; reference Functions/MyTimeParser)
_MYSQL_FMT = {
    "Y": "%Y", "y": "%y", "m": "%m", "d": "%d", "b": "%b", "M": "%B",
    "a": "%a", "W": "%A", "j": "%j", "H": "%H", "i": "%M", "s": "%S",
    "S": "%S", "T": "%H:%M:%S", "e": "%d", "c": "%m", "%": "%%",
}


def mysql_format_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            out.append(_MYSQL_FMT.get(spec, spec))
            i += 2
        else:
            out.append(ch.replace("%", "%%"))
            i += 1
    return "".join(out)


_MONTH_NAMES = ["january", "february", "march", "april", "may", "june",
                "july", "august", "september", "october", "november",
                "december"]


def _mysql_strptime_parts(s: str, fmt: str):
    """MySQL-lax STR_TO_DATE scanner (reference MyTimeParser /
    str_to_date.test): whitespace runs in the INPUT are skipped before
    every token, a whitespace run in the FORMAT matches any (even zero)
    input whitespace, %f accepts 0-6 digits (empty -> 0), numeric specs
    take 1-2 digits (4 for %Y, 3 for %j).  Returns a parts dict or
    None."""
    si, n = 0, len(s)
    vals: dict = {}

    def skip_ws():
        nonlocal si
        while si < n and s[si].isspace():
            si += 1

    def digits(maxd, mind=1):
        nonlocal si
        j = si
        while j < n and j - si < maxd and s[j].isdigit():
            j += 1
        if j - si < mind:
            return None
        v = int(s[si:j])
        si = j
        return v

    fi = 0
    while fi < len(fmt):
        ch = fmt[fi]
        if ch == "%" and fi + 1 < len(fmt):
            spec = fmt[fi + 1]
            fi += 2
            skip_ws()
            if spec == "%":
                if si < n and s[si] == "%":
                    si += 1
                    continue
                return None
            if spec == "f":
                j = si
                while j < n and s[j].isdigit():
                    j += 1
                frac = s[si:j]
                si = j
                vals["f"] = int((frac + "000000")[:6]) if frac else 0
                continue
            if spec in ("b", "M", "a", "W"):
                j = si
                while j < n and s[j].isalpha():
                    j += 1
                name = s[si:j].lower()
                si = j
                if spec in ("a", "W"):
                    continue  # weekday names carry no value
                for mi, full in enumerate(_MONTH_NAMES):
                    if name == full or (len(name) >= 3
                                        and full.startswith(name)):
                        vals["m"] = mi + 1
                        break
                else:
                    return None
                continue
            if spec == "p":
                word = s[si:si + 2].upper()
                if word not in ("AM", "PM"):
                    return None
                si += 2
                vals["p"] = word
                continue
            if spec == "T":
                for sub, sep in (("H", ":"), ("i", ":"), ("s", "")):
                    v = digits(2)
                    if v is None:
                        return None
                    vals[sub] = v
                    if sep:
                        if si < n and s[si] == sep:
                            si += 1
                        else:
                            return None
                continue
            if spec == "r":
                for sub, sep in (("I", ":"), ("i", ":"), ("s", "")):
                    v = digits(2)
                    if v is None:
                        return None
                    vals[sub] = v
                    if sep:
                        if si < n and s[si] == sep:
                            si += 1
                        else:
                            return None
                skip_ws()
                word = s[si:si + 2].upper()
                if word in ("AM", "PM"):
                    si += 2
                    vals["p"] = word
                continue
            width = {"Y": 4, "j": 3}.get(spec, 2)
            v = digits(width)
            if v is None:
                return None
            if spec == "y":
                vals["Y"] = 2000 + v if v < 70 else 1900 + v
            elif spec in ("e", "d"):
                vals["d"] = v
            elif spec == "c":
                vals["m"] = v
            elif spec in ("h", "I", "l"):
                vals["I"] = v
            elif spec == "k":
                vals["H"] = v
            elif spec == "S":
                vals["s"] = v
            else:
                vals[spec] = v
        elif ch.isspace():
            fi += 1
            skip_ws()
        else:
            skip_ws()
            if si < n and s[si] == ch:
                si += 1
                fi += 1
            else:
                return None
    if "I" in vals:  # 12-hour clock
        h = vals.pop("I") % 12
        if vals.get("p") == "PM":
            h += 12
        vals["H"] = h
    return vals


def str_to_date(s: str, fmt: str):
    """MySQL STR_TO_DATE -> datetime.date, or None on parse failure.
    Date-part specifiers only (the engine's DATE representation)."""
    import datetime as _dt

    vals = _mysql_strptime_parts(s, fmt)
    if vals is None:
        return None
    try:
        return _dt.date(vals["Y"], vals["m"], vals["d"])
    except ValueError:
        # MySQL stores PARTIAL zero dates: '0/0/2012' -> 2012-00-00
        # (str_to_date.test); all-zero -> 0000-00-00
        from ..core.dtypes import CivilDate, ZeroDate

        y, m, d = vals.get("Y", 0), vals.get("m", 0), vals.get("d", 0)
        if y == m == d == 0:
            return ZeroDate()
        if (0 <= y <= 9999 and 0 <= m <= 12 and 0 <= d <= 31
                and (m == 0 or d == 0)):
            return CivilDate(y, m, d)
        return None
    except Exception:
        return None


def format_mysql_date(d, fmt: str) -> str:
    """DATE_FORMAT for a datetime.date, MySQL specifiers (incl. %D suffix
    and zero time parts)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            i += 2
            if spec == "D":
                n = d.day
                sfx = "th" if 11 <= n % 100 <= 13 else \
                    {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")
                out.append(f"{n}{sfx}")
            elif spec in ("H", "i", "s", "S"):
                out.append("00")
            elif spec == "f":
                out.append("000000")
            elif spec == "T":
                out.append("00:00:00")
            elif spec == "r":
                out.append("12:00:00 AM")
            elif spec == "p":
                out.append("AM")
            elif spec == "k" or spec == "l":
                out.append("0" if spec == "k" else "12")
            elif spec == "e":
                out.append(str(d.day))
            elif spec == "c":
                out.append(str(d.month))
            elif spec == "%":
                out.append("%")
            elif spec in _MYSQL_FMT:
                out.append(d.strftime(_MYSQL_FMT[spec]))
            else:
                out.append(spec)
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def conv(s: str, from_base: int, to_base: int) -> Optional[str]:
    """MySQL CONV: parse the longest valid prefix in from_base; NULL only
    for unsupported bases."""
    fb, tb = int(from_base), int(to_base)
    if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
        return None
    t = s.strip()
    neg = t.startswith("-")
    if neg or t.startswith("+"):
        t = t[1:]
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:fb]
    val = 0
    seen = False
    for ch in t.lower():
        if ch not in digits:
            break
        val = val * fb + digits.index(ch)
        seen = True
    if not seen:
        return "0"
    if neg:
        val = -val
    # MySQL treats the value as unsigned 64-bit unless to_base < 0
    if tb > 0 and val < 0:
        val += 1 << 64
    sign = ""
    if tb < 0 and val < 0:
        sign, val = "-", -val
    tb = abs(tb)
    if val == 0:
        return "0"
    out = []
    alphabet = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    while val:
        out.append(alphabet[val % tb])
        val //= tb
    return sign + "".join(reversed(out))


def inet6_aton(s: str) -> Optional[str]:
    """MySQL INET6_ATON: the engine's VARBINARY stand-in is a lowercase
    hex string (16 bytes for IPv6, 4 for dotted-quad IPv4), matching the
    reference's tiDBIPv6StringToNum byte output rendered as hex."""
    import ipaddress

    try:
        return ipaddress.IPv6Address(s).packed.hex()
    except Exception:
        pass
    if is_ipv4(s):
        parts = [int(p) for p in s.split(".")]
        return bytes(parts).hex()
    return None


def inet6_ntoa(hexs: str) -> Optional[str]:
    """MySQL INET6_NTOA over the hex-string VARBINARY stand-in."""
    import ipaddress

    try:
        raw = bytes.fromhex(hexs)
    except ValueError:
        return None
    if len(raw) == 16:
        return str(ipaddress.IPv6Address(raw))
    if len(raw) == 4:
        return ".".join(str(b) for b in raw)
    return None


def inet_ntoa(v: int) -> Optional[str]:
    """MySQL INET_NTOA: int -> dotted quad (NULL outside u32 range)."""
    if v < 0 or v > 0xFFFFFFFF:
        return None
    return ".".join(str((v >> s) & 255) for s in (24, 16, 8, 0))


def mysql_char(*codes: int) -> str:
    """MySQL CHAR(N, ...): each value contributes its big-endian bytes;
    the result is interpreted as utf8 (invalid bytes dropped, matching
    CHAR(... USING utf8mb4) NULL-on-invalid loosely as lossy decode)."""
    out = b""
    for v in codes:
        u = int(v) & ((1 << 32) - 1)
        nb = max(1, (u.bit_length() + 7) // 8)
        out += u.to_bytes(nb, "big")
    return out.decode("utf-8", errors="ignore")


_TIME_SPECS = set("HhIiSsfTrp")


def format_has_time(fmt: str) -> bool:
    """True when a MySQL format string contains time-part specifiers —
    selects the strToDateDatetime sig over strToDateDate."""
    i = 0
    while i < len(fmt) - 1:
        if fmt[i] == "%":
            if fmt[i + 1] in _TIME_SPECS:
                return True
            i += 2
            continue
        i += 1
    return False


def str_to_datetime(s: str, fmt: str):
    """MySQL STR_TO_DATE with time parts -> datetime.datetime, or None
    (reference strToDateDatetime sig)."""
    import datetime as _dt

    vals = _mysql_strptime_parts(s, fmt)
    if vals is None:
        return None
    try:
        return _dt.datetime(vals["Y"], vals["m"], vals["d"],
                            vals.get("H", 0), vals.get("i", 0),
                            vals.get("s", 0), vals.get("f", 0))
    except Exception:
        return None
