"""Static C++ extraction for cross-language conformance (hvdabi) — the
port's copy of ``horovod_tpu/analysis/cpp.py``, over the port's own C++
core (``horovod_tpu_torch/core/src/``) and ``core/bindings.py``.

A lightweight declarative extractor — no compiler, no libclang — over:

* ``extern "C"`` export signatures with arg names and types,
* the counter-slot layout (``enum CounterSlot`` + the constexpr algebra
  that sizes it),
* span-phase literals (``enum SpanPhase``),
* frame-kind coverage anchors (``// hvdabi:frame-kind ...`` structured
  comments next to the control-frame plane),
* mutex members and their static lock/unlock regions.

Four checkers sit on top, surfaced through the Rule/baseline/CLI
machinery (HVD010/HVD011, ``tools/abicheck.py``, ``protocheck --native``
and the ``lockorder.static_graph()`` join):

1. **ABI bijection** — every exported C function ↔ ``bindings.py``
   argtypes/restype, arg-count *and* ctype-compatible, pinned by a
   generated manifest (``core/hvdabi-manifest.json``).
2. **Counter/metrics parity** — C counter slots ↔ the ``hvd_native_*``
   mirror in ``metrics`` ↔ the known-series pin in
   ``tests/test_torch_metrics_lint.py``.
3. **Native frame-kind coverage** — engine.cc's control-frame plane
   checked against the 7-kind SPEC in ``analysis.protocol``.
4. **C++ lock-graph join** — static mutex acquisition order merged into
   the whole-process acyclicity gate.

What the port does differently: its bindings declare each function
through one ``_c(lib, "name", restype, *argtypes)`` call over local
ctypes aliases, which :func:`parse_bindings` reads beside the JAX
package's ``lib.NAME.argtypes = [...]`` form; the TensorFlow op
library's ``CoreApi`` fn-pointer table is the port's own
(``tensorflow/src/tf_ops.cc``), checked against the port's
``engine.cc`` exports; and an export counts as consumed by a test only
in the port's own test files (``tests/test_torch_*.py``,
``tests/torch_*.py``).

Everything here is stdlib-only and parses sources as text; in
particular ``bindings.py`` is read via ``ast``, never imported (it pulls
in torch, and lint must run in a bare interpreter).
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Source inventory

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)

#: (tag, repo-relative path) for every C++ translation unit we analyze.
CPP_SOURCES: Tuple[Tuple[str, str], ...] = (
    ("engine", "horovod_tpu_torch/core/src/engine.cc"),
    ("ring", "horovod_tpu_torch/core/src/ring.cc"),
    ("shm", "horovod_tpu_torch/core/src/shm.cc"),
    ("timeline", "horovod_tpu_torch/core/src/timeline.h"),
    ("tf_ops", "horovod_tpu_torch/tensorflow/src/tf_ops.cc"),
)

BINDINGS_PATH = "horovod_tpu_torch/core/bindings.py"
METRICS_PATH = "horovod_tpu_torch/metrics/__init__.py"
METRICS_PIN_PATH = "tests/test_torch_metrics_lint.py"
MANIFEST_PATH = "horovod_tpu_torch/core/hvdabi-manifest.json"
MANIFEST_VERSION = 1
# Test files whose mention of an export counts as its consumer.
TEST_FILE_PREFIXES = ("test_torch_", "torch_")

# --------------------------------------------------------------------------
# Lexical stripping

_KEYWORDS = frozenset({
    "if", "for", "while", "switch", "return", "sizeof", "catch", "defined",
    "alignof", "new", "delete", "throw", "do", "else", "case", "goto",
    "static_assert", "assert", "decltype", "noexcept", "operator", "using",
    "template", "typedef", "typename",
})

_TYPE_WORDS = frozenset({
    "void", "int", "long", "char", "double", "float", "unsigned", "signed",
    "short", "bool", "size_t", "uint8_t", "uint16_t", "uint32_t", "uint64_t",
    "int8_t", "int16_t", "int32_t", "int64_t", "const", "struct", "enum",
})


def _strip(text: str) -> Tuple[str, str, List[Tuple[int, str]]]:
    """Blank comments (and, in the second copy, string contents) while
    preserving offsets and newlines exactly.

    Returns ``(code_nc, code, comments)``:

    * ``code_nc`` — comments blanked, string literals intact (needed for
      ``extern "C"`` and the tf_ops ``sym("...")`` map);
    * ``code`` — comments *and* string/char contents blanked (safe for
      brace matching and identifier scans);
    * ``comments`` — ``(lineno, text)`` per comment, 1-based, for the
      anchor and comment-lint passes (block comments yield one entry per
      line so line numbers stay accurate).
    """
    n = len(text)
    nc = list(text)   # comments blanked
    cd = list(text)   # comments + string contents blanked
    comments: List[Tuple[int, str]] = []
    i = 0
    line = 1
    while i < n:
        ch = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if ch == "\n":
            line += 1
            i += 1
            continue
        if ch == "/" and nxt == "/":
            j = i
            while j < n and text[j] != "\n":
                j += 1
            comments.append((line, text[i + 2:j].strip()))
            for k in range(i, j):
                nc[k] = " "
                cd[k] = " "
            i = j
            continue
        if ch == "/" and nxt == "*":
            j = i + 2
            cline = line
            buf_start = j
            while j < n and not (text[j] == "*" and j + 1 < n and
                                 text[j + 1] == "/"):
                if text[j] == "\n":
                    comments.append((cline, text[buf_start:j].strip()))
                    cline += 1
                    buf_start = j + 1
                j += 1
            comments.append((cline, text[buf_start:j].strip()))
            end = min(n, j + 2)
            for k in range(i, end):
                if text[k] != "\n":
                    nc[k] = " "
                    cd[k] = " "
            line = cline
            i = end
            continue
        if ch == '"' or ch == "'":
            quote = ch
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == quote or text[j] == "\n":
                    break
                j += 1
            for k in range(i + 1, min(j, n)):
                if text[k] != "\n":
                    cd[k] = " "
            line += text.count("\n", i, min(j + 1, n))
            i = min(j + 1, n)
            continue
        i += 1
    return "".join(nc), "".join(cd), comments


def _match_brace(code: str, open_idx: int,
                 open_ch: str = "{", close_ch: str = "}") -> int:
    """Index just past the brace that closes ``code[open_idx]``.

    ``code`` must be the string-blanked copy so literal braces can't
    unbalance the scan.  Returns ``len(code)`` if unbalanced.
    """
    depth = 0
    for i in range(open_idx, len(code)):
        c = code[i]
        if c == open_ch:
            depth += 1
        elif c == close_ch:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(code)


def _lineno(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


# --------------------------------------------------------------------------
# Preprocessor awareness (enough for the repo's sources)

def _preprocess(code: str) -> Tuple[str, set]:
    """Blank ``#if 0`` regions; record line numbers inside any other
    conditional region so declarations there can be flagged guarded.

    Returns ``(code', guarded_lines)`` with offsets preserved.
    """
    out = list(code)
    guarded: set = set()
    lines = code.split("\n")
    stack: List[Tuple[str, int]] = []  # (kind, start_line) 1-based
    blank_from: Optional[int] = None
    offset = 0
    for ln, raw in enumerate(lines, start=1):
        stripped = raw.strip()
        m = re.match(r"#\s*(if|ifdef|ifndef|else|elif|endif)\b(.*)", stripped)
        if m:
            directive, rest = m.group(1), m.group(2).strip()
            if directive in ("if", "ifdef", "ifndef"):
                kind = "if0" if (directive == "if" and rest == "0") else "cond"
                stack.append((kind, ln))
                if kind == "if0" and blank_from is None:
                    blank_from = offset + len(raw) + 1
            elif directive == "endif" and stack:
                kind, _start = stack.pop()
                if kind == "if0" and not any(k == "if0" for k, _ in stack):
                    end = offset
                    if blank_from is not None:
                        for k in range(blank_from, min(end, len(out))):
                            if out[k] != "\n":
                                out[k] = " "
                    blank_from = None
            # #else/#elif inside an #if 0 flips nothing we need: the
            # repo's sources use no such construct, and blanking the
            # whole region is the conservative choice for `#if 0`.
        else:
            if stack and blank_from is None:
                guarded.add(ln)
        offset += len(raw) + 1
    return "".join(out), guarded


# --------------------------------------------------------------------------
# Function signature parsing

_CAND_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
_ALLCAPS_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _split_params(paramtext: str) -> List[str]:
    parts: List[str] = []
    depth = 0
    cur = []
    for ch in paramtext:
        if ch in "(<":
            depth += 1
        elif ch in ")>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _norm_type(t: str) -> str:
    """Canonicalize a C type string: collapse whitespace, one space
    before ``*``/``&``, no space after."""
    t = re.sub(r"\s+", " ", t.strip())
    t = re.sub(r"\s*([*&])\s*", r"\1", t)
    t = re.sub(r"(?<=[\w>])([*&])", r" \1", t)
    return t.strip()


def _parse_param(p: str) -> Dict[str, str]:
    p = re.sub(r"\s+", " ", p.strip())
    if p in ("void", ""):
        return {}
    # Attach pointer/ref tokens to the type, then the last identifier
    # token (if any, and not itself a type word) is the parameter name.
    toks = re.findall(r"[\w:]+|\*|&", p)
    name = ""
    if len(toks) >= 2 and re.match(r"^[A-Za-z_]\w*$", toks[-1]) and \
            toks[-1] not in _TYPE_WORDS:
        name = toks[-1]
        toks = toks[:-1]
    return {"type": _norm_type(" ".join(toks)), "name": name}


def _ret_type(code: str, name_start: int) -> str:
    """Backward token scan from the function name to the previous
    statement boundary; drops linkage/storage words, ALL-CAPS macro
    tokens (macro-wrapped exports), and quotes."""
    j = name_start - 1
    while j >= 0 and code[j] not in ";{}()#":
        j -= 1
    seg = code[j + 1:name_start].replace('"', " ")
    if "=" in seg or "," in seg:
        return ""  # an assignment/argument expression, not a signature
    toks = [t for t in re.findall(r"[\w:]+|\*|&", seg)
            if t not in ("extern", "static", "inline", "constexpr")
            and not _ALLCAPS_RE.match(t)]
    ret = _norm_type(" ".join(toks))
    return ret


def parse_functions(code_nc: str, code: str,
                    guarded_lines: Optional[set] = None) -> List[dict]:
    """Every function definition/declaration candidate in a TU.

    Each entry: ``{name, ret, params, line, kind: 'def'|'decl',
    extern_c, guarded, body_span}`` where ``body_span`` is the
    ``(start, end)`` offset pair of a definition body (braces included)
    or ``None`` for declarations.
    """
    guarded_lines = guarded_lines or set()
    # extern "C" spans: block form and single-decl form.
    spans: List[Tuple[int, int]] = []
    for m in re.finditer(r'extern\s*"C"', code_nc):
        j = m.end()
        while j < len(code) and code[j] in " \t\n":
            j += 1
        if j < len(code) and code[j] == "{":
            spans.append((j, _match_brace(code, j)))
        else:
            # single declaration / definition: runs to the first `;` at
            # depth 0 or the end of a matched `{...}` body.
            k = j
            depth = 0
            while k < len(code):
                c = code[k]
                if c in "({":
                    if c == "{" and depth == 0:
                        k = _match_brace(code, k)
                        break
                    depth += 1
                elif c in ")}":
                    depth -= 1
                elif c == ";" and depth == 0:
                    k += 1
                    break
                k += 1
            spans.append((j, k))

    def _in_extern_c(off: int) -> bool:
        return any(a <= off < b for a, b in spans)

    out: List[dict] = []
    for m in _CAND_RE.finditer(code):
        name = m.group(1)
        if name in _KEYWORDS:
            continue
        start = m.start(1)
        if start > 0 and code[start - 1] == ":":
            continue  # qualified (ns::f / Class::f handled via full tokens)
        open_paren = code.index("(", m.end(1) - 1) \
            if code[m.end(1) - 1] != "(" else m.end(1) - 1
        open_paren = m.end() - 1
        close = _match_brace(code, open_paren, "(", ")")
        if close >= len(code):
            continue
        # Skip trailing qualifiers to find `;` (decl) or `{` (def).
        k = close
        while k < len(code):
            rest = code[k:]
            mq = re.match(r"\s*(const|noexcept|override|final)\b", rest)
            if mq:
                k += mq.end()
                continue
            break
        while k < len(code) and code[k] in " \t\n":
            k += 1
        if k >= len(code) or code[k] not in ";{":
            continue
        kind = "def" if code[k] == "{" else "decl"
        ret = _ret_type(code, start)
        if not ret or any(t in _KEYWORDS for t in ret.split()):
            continue  # a call, a ctor, `throw X(...)`, ...
        params = [_parse_param(p)
                  for p in _split_params(code[open_paren + 1:close - 1])]
        params = [p for p in params if p]
        line = _lineno(code, start)
        body_span = (k, _match_brace(code, k)) if kind == "def" else None
        out.append({
            "name": name,
            "ret": ret,
            "params": params,
            "line": line,
            "kind": kind,
            "extern_c": _in_extern_c(start),
            "guarded": line in guarded_lines,
            "body_span": body_span,
        })
    return out


# --------------------------------------------------------------------------
# Counter slots, span phases

_CONSTEXPR_RE = re.compile(
    r"constexpr\s+(?:std::)?(?:int|long|size_t|unsigned)\s+"
    r"(\w+)\s*=\s*([^;]+);")
_SUFFIX_RE = re.compile(r"(?<=\d)[uUlL]+\b")


def _eval_int(expr: str, symbols: Dict[str, int]) -> Optional[int]:
    expr = _SUFFIX_RE.sub("", expr.strip())
    for name in sorted(symbols, key=len, reverse=True):
        expr = re.sub(r"\b%s\b" % re.escape(name), str(symbols[name]), expr)
    if re.search(r"[A-Za-z_]", expr):
        return None
    if not re.fullmatch(r"[\d\s+\-*/()<>&|~%]+", expr):
        return None
    try:
        return int(eval(expr, {"__builtins__": {}}, {}))  # noqa: S307
    except Exception:
        return None


def _constexpr_symbols(code: str) -> Dict[str, int]:
    symbols: Dict[str, int] = {}
    for m in _CONSTEXPR_RE.finditer(code):
        val = _eval_int(m.group(2), symbols)
        if val is not None:
            symbols[m.group(1)] = val
    return symbols


def parse_enum(code: str, name: str,
               symbols: Optional[Dict[str, int]] = None
               ) -> List[Tuple[str, int]]:
    """``(enumerator, value)`` pairs of ``enum [class] <name>`` in
    declaration order, evaluating the constexpr algebra as needed."""
    symbols = dict(symbols or {})
    m = re.search(r"enum\s+(?:class\s+)?%s\b[^({]*\{" % re.escape(name), code)
    if not m:
        return []
    open_idx = code.index("{", m.start())
    body = code[open_idx + 1:_match_brace(code, open_idx) - 1]
    out: List[Tuple[str, int]] = []
    nxt = 0
    for entry in _split_params(body):
        if "=" in entry:
            ident, expr = entry.split("=", 1)
            val = _eval_int(expr, symbols)
            if val is None:
                continue
        else:
            ident, val = entry, nxt
        ident = ident.strip()
        if not re.match(r"^[A-Za-z_]\w*$", ident):
            continue
        out.append((ident, val))
        symbols[ident] = val
        nxt = val + 1
    return out


def extract_counters(engine_code: str) -> dict:
    """The counter-slot layout: ``{slots, scalars, hist_buckets,
    hist_slots, n_slots}``.  ``scalars`` is the ordered lowercase list
    up to (excluding) the first histogram-block enumerator — the list
    ``bindings.NATIVE_COUNTER_SCALARS`` must mirror exactly."""
    symbols = _constexpr_symbols(engine_code)
    pairs = parse_enum(engine_code, "CounterSlot", symbols)
    slots = {name: val for name, val in pairs}
    scalars: List[str] = []
    for name, _val in pairs:
        if name.endswith("_HIST_COUNT"):
            break
        if name.startswith("N_"):
            break
        scalars.append(name[len("CTR_"):].lower()
                       if name.startswith("CTR_") else name.lower())
    return {
        "slots": slots,
        "scalars": scalars,
        "hist_buckets": symbols.get("kHistBuckets"),
        "hist_slots": symbols.get("kHistSlots"),
        "n_slots": slots.get("N_COUNTER_SLOTS"),
    }


def extract_span_phases(engine_code: str) -> List[str]:
    pairs = parse_enum(engine_code, "SpanPhase",
                       _constexpr_symbols(engine_code))
    return [name[len("PH_"):].lower() if name.startswith("PH_")
            else name.lower() for name, _ in pairs
            if not name.startswith("N_")]


# --------------------------------------------------------------------------
# Frame-kind coverage anchors

_ANCHOR_RE = re.compile(r"hvdabi:frame-kind\s+(.*)")


def parse_frame_anchors(comments: Iterable[Tuple[int, str]]) -> List[dict]:
    """Structured ``// hvdabi:frame-kind kind=<k> status=<s> ...``
    coverage anchors, in file order."""
    out = []
    for line, text in comments:
        m = _ANCHOR_RE.search(text)
        if not m:
            continue
        fields = dict(kv.split("=", 1) for kv in m.group(1).split()
                      if "=" in kv)
        fields["line"] = line
        out.append(fields)
    return out


def check_native_frames(engine_funcs: Sequence[dict],
                        anchors: Sequence[dict],
                        kinds: Sequence[str],
                        relpath: str) -> Tuple[List[dict], dict]:
    """Frame-kind coverage of the native engine vs the protocol SPEC.

    A kind with no anchor at all is a *silent drop* — a finding.  An
    anchor that declares ``status=unsupported`` is coverage info (the
    named ROADMAP gap), reported but not a finding.  Unknown kinds,
    duplicates, and handled-kinds whose ``via`` function doesn't exist
    are findings.
    """
    findings: List[dict] = []
    defined = {f["name"] for f in engine_funcs}
    seen: Dict[str, dict] = {}
    for a in anchors:
        kind = a.get("kind", "")
        if kind not in kinds:
            findings.append(_finding(
                "native-frames", relpath, a["line"],
                "anchor names unknown frame kind %r (SPEC kinds: %s)"
                % (kind, ", ".join(kinds))))
            continue
        if kind in seen:
            findings.append(_finding(
                "native-frames", relpath, a["line"],
                "duplicate frame-kind anchor for %r (first at line %d)"
                % (kind, seen[kind]["line"])))
            continue
        seen[kind] = a
        status = a.get("status", "")
        if status not in ("handled", "unsupported"):
            findings.append(_finding(
                "native-frames", relpath, a["line"],
                "frame-kind anchor for %r has status=%r "
                "(must be handled|unsupported)" % (kind, status)))
        elif status == "handled":
            via = a.get("via", "")
            if via not in defined:
                findings.append(_finding(
                    "native-frames", relpath, a["line"],
                    "frame kind %r declared handled via %r, but no such "
                    "function is defined in the engine" % (kind, via)))
    for kind in kinds:
        if kind not in seen:
            findings.append(_finding(
                "native-frames", relpath, 0,
                "frame kind %r has no coverage anchor: the native engine "
                "would silently drop it (add a hvdabi:frame-kind anchor "
                "declaring handled|unsupported)" % kind))
    coverage = {
        k: {"status": seen[k].get("status", "?"),
            **({"via": seen[k]["via"]} if seen[k].get("via") else {})}
        for k in kinds if k in seen
    }
    return findings, coverage


# --------------------------------------------------------------------------
# Static lock regions

_GUARD_RE = re.compile(
    r"\b(?:std::)?(lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s*"
    r"(\w+)\s*\(\s*([\w:.\->]+?)\s*[),]")
_LOCKOP_RE = re.compile(r"\b(\w+)\s*\.\s*(lock|unlock)\s*\(\s*\)")
_CALL_RE = re.compile(r"(?:\b(g_\w+)\s*->\s*)?\b([A-Za-z_]\w*)\s*\(")
_MUTEX_RE = re.compile(r"\b(?:std::)?(?:mutex|recursive_mutex)\s+(\w+)\s*;")


def _last_component(expr: str) -> str:
    return re.split(r"::|\.|->", expr)[-1].strip()


def parse_mutexes(code: str) -> List[Tuple[str, int]]:
    return [(m.group(1), _lineno(code, m.start()))
            for m in _MUTEX_RE.finditer(code)]


def _scan_body(code: str, span: Tuple[int, int], mutex_names: set,
               defined: set) -> Tuple[List[Tuple[Tuple[str, ...], str]],
                                      List[Tuple[Tuple[str, ...], str]],
                                      List[Tuple[Tuple[str, ...], str]]]:
    """One pass over a function body.  Returns ``(acquisitions, calls,
    held_calls)`` where acquisitions are ``(held_before, mutex)`` and
    calls are ``(held, callee)`` — callees restricted to bare calls and
    ``g_*->method(...)`` receiver calls (see the design note below)."""
    start, end = span
    body = code[start:end]
    events = []  # (offset, kind, payload)
    for i, ch in enumerate(body):
        if ch == "{":
            events.append((i, "open", None))
        elif ch == "}":
            events.append((i, "close", None))
    for m in _GUARD_RE.finditer(body):
        mu = _last_component(m.group(3))
        if mu in mutex_names:
            events.append((m.start(), "guard", (m.group(2), mu)))
    for m in _LOCKOP_RE.finditer(body):
        events.append((m.start(), m.group(2), m.group(1)))
    for m in _CALL_RE.finditer(body):
        recv, callee = m.group(1), m.group(2)
        if callee in _KEYWORDS or callee in ("lock", "unlock"):
            continue
        if recv is None:
            # Bare calls only: a receiver call like `cv_.wait(lk)` would
            # otherwise resolve by bare name to Engine::wait and
            # fabricate a self-deadlock edge.  `g_*->f(...)` is the one
            # receiver pattern we keep (global engine handle).
            prev = body[:m.start()].rstrip()[-1:]
            if prev in (".", ">", ":"):
                continue
        if callee not in defined:
            continue
        events.append((m.start(), "call", callee))
    events.sort(key=lambda e: (e[0], 0 if e[1] in ("open", "close") else 1))

    acquisitions: List[Tuple[Tuple[str, ...], str]] = []
    calls: List[Tuple[Tuple[str, ...], str]] = []
    held_calls: List[Tuple[Tuple[str, ...], str]] = []
    depth = 0
    # Active guards: list of [var, mutex, depth, active]
    guards: List[List] = []

    def held() -> Tuple[str, ...]:
        seen = []
        for g in guards:
            if g[3] and g[1] not in seen:
                seen.append(g[1])
        return tuple(seen)

    for _off, kind, payload in events:
        if kind == "open":
            depth += 1
        elif kind == "close":
            depth -= 1
            guards = [g for g in guards if g[2] <= depth]
        elif kind == "guard":
            var, mu = payload
            acquisitions.append((held(), mu))
            guards.append([var, mu, depth, True])
        elif kind == "unlock":
            for g in reversed(guards):
                if g[0] == payload:
                    g[3] = False
                    break
        elif kind == "lock":
            for g in reversed(guards):
                if g[0] == payload:
                    if not g[3]:
                        acquisitions.append((held(), g[1]))
                        g[3] = True
                    break
        elif kind == "call":
            h = held()
            calls.append((h, payload))
            if h:
                held_calls.append((h, payload))
    return acquisitions, calls, held_calls


def lock_graph(sources: Optional[Dict[str, dict]] = None) -> dict:
    """Static mutex acquisition-order graph of the C++ core.

    Lock names are ``native.<tag>.<mutex>`` so they can never collide
    with the Python ``make_lock`` namespace; ``via`` strings name the
    deriving function as ``<relpath>::<func>``.  Best-effort by design:
    propagation crosses only bare calls and ``g_*->f()`` receiver calls
    (the global-engine pattern), which captures the one real cross-lock
    edge on HEAD (``hvd_eng_shutdown`` holding ``g_engine_mu`` calling
    into ``Engine::finish`` → ``mu_``) without fabricating edges from
    condition-variable waits.
    """
    sources = sources if sources is not None else load_sources()
    per_tag = {}
    defined_local: Dict[str, set] = {}
    extern_defs: Dict[str, str] = {}  # extern "C" def name -> tag
    for tag, src in sources.items():
        mutexes = parse_mutexes(src["code"])
        names = {m for m, _ in mutexes}
        defs = [f for f in src["functions"] if f["kind"] == "def"]
        per_tag[tag] = (src, names, defs)
        defined_local[tag] = {f["name"] for f in defs}
        for f in defs:
            if f["extern_c"]:
                extern_defs[f["name"]] = tag

    def resolve(tag: str, callee: str) -> List[Tuple[str, str]]:
        # Bare calls resolve within their own TU first; across TUs only
        # through the extern "C" surface — cross-TU resolution by bare
        # name would alias unrelated helpers (set_error, dtype_size, ...)
        # and fabricate edges.
        if callee in defined_local[tag]:
            return [(tag, callee)]
        if callee in extern_defs:
            return [(extern_defs[callee], callee)]
        return []

    # Per-function direct acquisitions and restricted call edges.
    acq: Dict[Tuple[str, str], List[Tuple[Tuple[str, ...], str]]] = {}
    fcalls: Dict[Tuple[str, str], List[Tuple[Tuple[str, ...], str]]] = {}
    all_defined = set(extern_defs)
    for tag in per_tag:
        all_defined |= defined_local[tag]
    for tag, (src, names, defs) in per_tag.items():
        for f in defs:
            a, c, _hc = _scan_body(src["code"], f["body_span"], names,
                                   all_defined)
            acq[(tag, f["name"])] = a
            fcalls[(tag, f["name"])] = c

    # may-acquire fixpoint: which (tag, mutex) pairs can a call into
    # f() end up taking?
    may: Dict[Tuple[str, str], set] = {
        (tag, fname): {(tag, mu) for _held, mu in v}
        for (tag, fname), v in acq.items()}
    changed = True
    while changed:
        changed = False
        for (tag, fname), calls in fcalls.items():
            cur = may[(tag, fname)]
            for _held, callee in calls:
                for ck in resolve(tag, callee):
                    extra = may.get(ck, set()) - cur
                    if extra:
                        cur |= extra
                        changed = True

    def lname(tag: str, mu: str) -> str:
        return "native.%s.%s" % (tag, mu)

    edges: Dict[Tuple[str, str], dict] = {}
    locks: set = set()
    for tag, (src, names, defs) in per_tag.items():
        relpath = src["relpath"]
        for f in defs:
            k = (tag, f["name"])
            for held, mu in acq[k]:
                locks.add(lname(tag, mu))
                for h in held:
                    e = (lname(tag, h), lname(tag, mu))
                    if e[0] == e[1]:
                        continue
                    cur = edges.setdefault(
                        e, {"via": "%s::%s" % (relpath, f["name"]),
                            "count": 0})
                    cur["count"] += 1
            for held, callee in fcalls[k]:
                if not held:
                    continue
                for ck in resolve(tag, callee):
                    for mtag, mu in may.get(ck, set()):
                        locks.add(lname(mtag, mu))
                        for h in held:
                            e = (lname(tag, h), lname(mtag, mu))
                            if e[0] == e[1]:
                                continue
                            cur = edges.setdefault(
                                e, {"via": "%s::%s -> %s"
                                    % (relpath, f["name"], callee),
                                    "count": 0})
                            cur["count"] += 1
    for tag, (src, names, _defs) in per_tag.items():
        for mu in names:
            locks.add(lname(tag, mu))
    return {
        "locks": sorted(locks),
        "edges": [{"from": a, "to": b, **meta}
                  for (a, b), meta in sorted(edges.items())],
    }


# --------------------------------------------------------------------------
# bindings.py (ctypes) — parsed via ast, never imported

def _ctype_str(node: ast.AST,
               aliases: Optional[Dict[str, str]] = None) -> Optional[str]:
    """The ctypes spelling of an expression (``c_int``,
    ``POINTER(c_double)``); a bare name resolves through ``aliases``
    (local names bound to ctypes types, the port's ``vp, i = ...``)."""
    if isinstance(node, ast.Constant) and node.value is None:
        return None
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return (aliases or {}).get(node.id, node.id)
    if isinstance(node, ast.Call):
        fn = _ctype_str(node.func, aliases)
        inner = [_ctype_str(a, aliases) for a in node.args]
        return "%s(%s)" % (fn, ",".join(str(i) for i in inner))
    return "?"


def _is_ctypes_expr(node: ast.AST) -> bool:
    """``ctypes.X`` or ``ctypes.POINTER(...)``: what an alias may bind."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "ctypes")


def _ctypes_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local names bound to ctypes types anywhere in the module: ``vp =
    ctypes.c_void_p`` and tuple forms ``vp, i = (ctypes.c_void_p,
    ctypes.c_int)``, resolved in source order (``llp =
    ctypes.POINTER(ll)`` sees ``ll``)."""
    aliases: Dict[str, str] = {}
    assigns = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                      and len(n.targets) == 1),
                     key=lambda n: (n.lineno, n.col_offset))
    for node in assigns:
        tgt, val = node.targets[0], node.value
        pairs = []
        if isinstance(tgt, ast.Name):
            pairs = [(tgt, val)]
        elif isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) \
                and len(tgt.elts) == len(val.elts):
            pairs = list(zip(tgt.elts, val.elts))
        for t, v in pairs:
            if isinstance(t, ast.Name) and _is_ctypes_expr(v):
                aliases[t.id] = _ctype_str(v, aliases)
    return aliases


def parse_bindings(source: str) -> dict:
    """``{name: {argtypes: [...]|None, restype: str|None,
    argtypes_line, restype_line}}`` from every ``lib.NAME.argtypes=``/
    ``.restype=`` assignment and every ``_c(lib, "NAME", restype,
    *argtypes)`` declaration, plus the module-level layout constants."""
    tree = ast.parse(source)
    decls: Dict[str, dict] = {}
    consts: Dict[str, object] = {}
    aliases = _ctypes_aliases(tree)

    def _const_eval(node: ast.AST):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Tuple):
            vals = [_const_eval(e) for e in node.elts]
            return None if any(v is None for v in vals) else tuple(vals)
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        if isinstance(node, ast.BinOp):
            lo, ro = _const_eval(node.left), _const_eval(node.right)
            if lo is None or ro is None:
                return None
            if isinstance(node.op, ast.Add):
                return lo + ro
            if isinstance(node.op, ast.Sub):
                return lo - ro
            if isinstance(node.op, ast.Mult):
                return lo * ro
            return None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len":
            v = _const_eval(node.args[0]) if node.args else None
            return None if v is None else len(v)
        return None

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_c" and len(node.args) >= 3
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "lib"
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)):
            decls[node.args[1].value] = {
                "argtypes": [_ctype_str(a, aliases) for a in node.args[3:]],
                "restype": _ctype_str(node.args[2], aliases),
                "argtypes_line": node.lineno, "restype_line": node.lineno}
            continue
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and tgt.col_offset == 0:
            consts[tgt.id] = _const_eval(node.value)
            continue
        if not (isinstance(tgt, ast.Attribute) and
                isinstance(tgt.value, ast.Attribute) and
                isinstance(tgt.value.value, ast.Name) and
                tgt.value.value.id == "lib" and
                tgt.attr in ("argtypes", "restype")):
            continue
        fname = tgt.value.attr
        d = decls.setdefault(fname, {"argtypes": None, "restype": None,
                                     "argtypes_line": None,
                                     "restype_line": None})
        if tgt.attr == "argtypes":
            if isinstance(node.value, (ast.List, ast.Tuple)):
                d["argtypes"] = [_ctype_str(e) for e in node.value.elts]
            else:
                d["argtypes"] = []
            d["argtypes_line"] = node.lineno
        else:
            d["restype"] = _ctype_str(node.value)
            d["restype_line"] = node.lineno
    return {"decls": decls, "constants": consts}


# C type -> acceptable ctypes spellings.  Keyed by normalized C type.
_CTYPE_COMPAT: Dict[str, Tuple[str, ...]] = {
    "int": ("c_int",),
    "long": ("c_long",),
    "long long": ("c_longlong",),
    "double": ("c_double",),
    "float": ("c_float",),
    "const char *": ("c_char_p",),
    "char *": ("c_char_p", "c_void_p"),
    "void *": ("c_void_p",),
    "const void *": ("c_void_p",),
    "const uint8_t *": ("POINTER(c_uint8)",),
    "uint8_t *": ("POINTER(c_uint8)",),
    "int *": ("POINTER(c_int)",),
    "double *": ("POINTER(c_double)",),
    "long *": ("POINTER(c_long)",),
    "const long *": ("POINTER(c_long)",),
    "long long *": ("POINTER(c_longlong)",),
    "const long long *": ("POINTER(c_longlong)",),
}


def _ctype_ok(ctype: Optional[str], c_type: str) -> bool:
    c_type = _norm_type(c_type)
    if c_type == "void":
        return ctype is None
    allowed = _CTYPE_COMPAT.get(c_type)
    if allowed is None:
        # Unknown C type: only flag an outright arity/None mismatch.
        return ctype is not None
    return ctype in allowed


# --------------------------------------------------------------------------
# tf_ops.cc CoreApi

_FIELD_RE = re.compile(r"([\w :*<>&]+?)\(\s*\*\s*(\w+)\s*\)\s*\(([^)]*)\)")
_SYM_RE = re.compile(
    r"a->(\w+)\s*=\s*reinterpret_cast<.*?>\(\s*sym\(\s*\"(\w+)\"\s*\)\s*\)",
    re.S)


def parse_core_api(code_nc: str, code: str) -> dict:
    """The ``CoreApi`` fn-pointer struct and its dlsym map:
    ``{fields: {name: {ret, args, line}}, symbols: {field: c_symbol}}``.
    """
    m = re.search(r"struct\s+CoreApi\b[^{;]*\{", code)
    fields: Dict[str, dict] = {}
    if m:
        open_idx = code.index("{", m.start())
        body_start, body_end = open_idx + 1, _match_brace(code, open_idx) - 1
        body = code[body_start:body_end]
        for fm in _FIELD_RE.finditer(body):
            args = [_norm_type(p) for p in _split_params(fm.group(3))
                    if _norm_type(p) != "void"]
            fields[fm.group(2)] = {
                "ret": _norm_type(fm.group(1)),
                "args": args,
                "line": _lineno(code, body_start + fm.start()),
            }
    symbols = {m.group(1): m.group(2) for m in _SYM_RE.finditer(code_nc)}
    return {"fields": fields, "symbols": symbols}


# --------------------------------------------------------------------------
# Loading

_SOURCE_CACHE: Dict[str, Tuple[tuple, Dict[str, dict]]] = {}


def load_sources(root: Optional[str] = None) -> Dict[str, dict]:
    """Parse every C++ TU once: ``{tag: {relpath, text, code_nc, code,
    comments, functions, guarded_lines}}``.

    Cached per root keyed on file mtimes/sizes: lint runs the HVD010/
    HVD011 rules plus the fixture proofs in one process, and re-parsing
    ~6k lines of C++ for each would multiply tier-1 seconds for
    nothing. An edited source invalidates naturally."""
    root = root or _REPO_DIR
    stamp = []
    for _tag, relpath in CPP_SOURCES:
        path = os.path.join(root, relpath)
        try:
            st = os.stat(path)
            stamp.append((relpath, st.st_mtime_ns, st.st_size))
        except OSError:
            stamp.append((relpath, None, None))
    cached = _SOURCE_CACHE.get(root)
    if cached is not None and cached[0] == tuple(stamp):
        return cached[1]
    out: Dict[str, dict] = {}
    for tag, relpath in CPP_SOURCES:
        path = os.path.join(root, relpath)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = f.read()
        code_nc, code, comments = _strip(text)
        code, guarded = _preprocess(code)
        code_nc, _g2 = _preprocess(code_nc)
        functions = parse_functions(code_nc, code, guarded)
        out[tag] = {
            "relpath": relpath,
            "text": text,
            "code_nc": code_nc,
            "code": code,
            "comments": comments,
            "functions": functions,
            "guarded_lines": guarded,
        }
    _SOURCE_CACHE[root] = (tuple(stamp), out)
    return out


def _read(root: str, relpath: str) -> str:
    with open(os.path.join(root, relpath)) as f:
        return f.read()


def exports(sources: Dict[str, dict]) -> Dict[str, dict]:
    """Exported C symbols: defined ``extern "C"`` functions across all
    TUs, keyed by name.  Definitions win over forward declarations."""
    out: Dict[str, dict] = {}
    for tag, src in sources.items():
        for f in src["functions"]:
            if not f["extern_c"] or not f["name"].startswith("hvd_"):
                continue
            if f["kind"] != "def":
                continue
            out[f["name"]] = {**f, "tag": tag, "relpath": src["relpath"]}
    return out


def extern_decls(sources: Dict[str, dict]) -> List[dict]:
    """``extern "C"`` forward *declarations* (consumer side), for the
    decl-vs-def cross-TU check."""
    out = []
    for tag, src in sources.items():
        for f in src["functions"]:
            if f["extern_c"] and f["kind"] == "decl" and \
                    f["name"].startswith("hvd_"):
                out.append({**f, "tag": tag, "relpath": src["relpath"]})
    return out


# --------------------------------------------------------------------------
# Findings

def _finding(check: str, path: str, line: int, message: str) -> dict:
    return {"check": check, "path": path, "line": line, "message": message}


def _fmt_args(params: Sequence[dict]) -> str:
    return ", ".join(p["type"] for p in params)


def abi_findings(sources: Dict[str, dict], bindings: dict,
                 core_api: dict, root: Optional[str] = None) -> List[dict]:
    """Checker 1: the ABI bijection across C exports, ctypes bindings,
    and the tf_ops CoreApi fn-pointer table."""
    root = root or _REPO_DIR
    findings: List[dict] = []
    exp = exports(sources)
    decls = bindings["decls"]

    # -- ctypes declarations vs C definitions ----------------------------
    for name, d in sorted(decls.items()):
        line = d["argtypes_line"] or d["restype_line"] or 0
        if name not in exp:
            findings.append(_finding(
                "abi", BINDINGS_PATH, line,
                "bindings declare %s but no extern \"C\" definition "
                "exists in the C++ core" % name))
            continue
        c = exp[name]
        if d["argtypes"] is None:
            # restype-only binding: ctypes defaults every argument to
            # c_int, so this is only sound for 0-arg C functions.
            if c["params"]:
                findings.append(_finding(
                    "abi", BINDINGS_PATH, line,
                    "%s has no argtypes pin but the C definition takes "
                    "%d argument(s) (%s) — ctypes would default them to "
                    "c_int" % (name, len(c["params"]),
                               _fmt_args(c["params"]))))
            continue
        if len(d["argtypes"]) != len(c["params"]):
            findings.append(_finding(
                "abi", BINDINGS_PATH, d["argtypes_line"] or line,
                "%s argtypes has %d entries but the C definition at "
                "%s:%d takes %d (%s)" % (
                    name, len(d["argtypes"]), c["relpath"], c["line"],
                    len(c["params"]), _fmt_args(c["params"]))))
        else:
            for i, (ct, p) in enumerate(zip(d["argtypes"], c["params"])):
                if not _ctype_ok(ct, p["type"]):
                    findings.append(_finding(
                        "abi", BINDINGS_PATH, d["argtypes_line"] or line,
                        "%s argument %d (%s): ctypes %s is not "
                        "compatible with C type %s" % (
                            name, i, p["name"] or "?", ct, p["type"])))
        if not _ctype_ok(d["restype"], c["ret"]):
            findings.append(_finding(
                "abi", BINDINGS_PATH, d["restype_line"] or line,
                "%s restype %s is not compatible with C return type %s"
                % (name, d["restype"], c["ret"])))

    # -- CoreApi fn-pointer table vs C definitions -----------------------
    tf_rel = dict(CPP_SOURCES)["tf_ops"]
    for field, meta in sorted(core_api["fields"].items()):
        symbol = core_api["symbols"].get(field)
        if symbol is None:
            findings.append(_finding(
                "abi", tf_rel, meta["line"],
                "CoreApi field %s is never resolved via sym(...)"
                % field))
            continue
        if symbol not in exp:
            findings.append(_finding(
                "abi", tf_rel, meta["line"],
                "CoreApi field %s resolves symbol %s which has no "
                "extern \"C\" definition" % (field, symbol)))
            continue
        c = exp[symbol]
        c_args = [_norm_type(p["type"]) for p in c["params"]]
        if meta["args"] != c_args:
            findings.append(_finding(
                "abi", tf_rel, meta["line"],
                "CoreApi field %s (-> %s) argument types %s do not "
                "match the C definition %s — a stale fn-pointer type "
                "reads garbage off the stack" % (
                    field, symbol, "(%s)" % ", ".join(meta["args"]),
                    "(%s)" % _fmt_args(c["params"]))))
        if meta["ret"] != _norm_type(c["ret"]):
            findings.append(_finding(
                "abi", tf_rel, meta["line"],
                "CoreApi field %s (-> %s) return type %s does not match "
                "the C definition's %s" % (
                    field, symbol, meta["ret"], c["ret"])))
    for field, symbol in sorted(core_api["symbols"].items()):
        if field not in core_api["fields"]:
            findings.append(_finding(
                "abi", tf_rel, 0,
                "sym map resolves %s into unknown CoreApi field %s"
                % (symbol, field)))

    # -- export consumption: every export has at least one consumer ------
    consumed = set(decls)
    consumed |= set(core_api["symbols"].values())
    for tag, src in sources.items():
        for name in exp:
            if exp[name]["tag"] != tag and name in src["code_nc"]:
                consumed.add(name)
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        for fname in sorted(os.listdir(tests_dir)):
            if not fname.endswith(".py") or \
                    not fname.startswith(TEST_FILE_PREFIXES):
                continue
            try:
                text = _read(root, os.path.join("tests", fname))
            except OSError:
                continue
            for name in exp:
                if name in text:
                    consumed.add(name)
    for name, c in sorted(exp.items()):
        if name not in consumed:
            findings.append(_finding(
                "abi", c["relpath"], c["line"],
                "exported symbol %s has no consumer (bindings, CoreApi, "
                "sibling TU, or tests)" % name))

    # -- extern "C" forward decls vs the real definitions ----------------
    for d in extern_decls(sources):
        c = exp.get(d["name"])
        if c is None or c["relpath"] == d["relpath"]:
            continue
        d_args = [_norm_type(p["type"]) for p in d["params"]]
        c_args = [_norm_type(p["type"]) for p in c["params"]]
        if d_args != c_args or _norm_type(d["ret"]) != _norm_type(c["ret"]):
            findings.append(_finding(
                "abi", d["relpath"], d["line"],
                "forward declaration of %s (%s) -> %s disagrees with the "
                "definition at %s:%d (%s) -> %s" % (
                    d["name"], ", ".join(d_args), d["ret"],
                    c["relpath"], c["line"], ", ".join(c_args), c["ret"])))

    # -- comment lint: stale arities and phantom binding constants -------
    candidate_lines: Dict[str, List[Tuple[int, int]]] = {}
    for tag, src in sources.items():
        candidate_lines[tag] = sorted(
            (f["line"], len(f["params"])) for f in src["functions"])
    arity_re = re.compile(r"\b(\d+)-arg\b")
    const_re = re.compile(r"\b((?:N_)?NATIVE_[A-Z0-9_]+)\b")
    binding_consts = set(bindings["constants"])
    for tag, src in sources.items():
        fields = core_api["fields"] if tag == "tf_ops" else {}
        for line, text in src["comments"]:
            for m in arity_re.finditer(text):
                want = int(m.group(1))
                near = [n for ln, n in candidate_lines[tag]
                        if line <= ln <= line + 12]
                near += [len(meta["args"]) for meta in fields.values()
                         if line <= meta["line"] <= line + 12]
                if near and want not in near:
                    findings.append(_finding(
                        "abi", src["relpath"], line,
                        "comment says \"%d-arg\" but the signatures in "
                        "the next 12 lines take %s argument(s)" % (
                            want, sorted(set(near)))))
            for m in const_re.finditer(text):
                if m.group(1) not in binding_consts:
                    findings.append(_finding(
                        "abi", src["relpath"], line,
                        "comment references bindings constant %s which "
                        "does not exist (did the mirror get renamed?)"
                        % m.group(1)))
    return findings


def bindings_source_findings(source: str,
                             root: Optional[str] = None) -> List[dict]:
    """HVD010 entry point: ABI findings anchored in bindings.py,
    computed from *this* source text against the real C++ sources."""
    root = root or _REPO_DIR
    sources = load_sources(root)
    if "engine" not in sources:
        return []
    bindings = parse_bindings(source)
    tf = sources.get("tf_ops")
    core_api = parse_core_api(tf["code_nc"], tf["code"]) if tf else \
        {"fields": {}, "symbols": {}}
    return [f for f in abi_findings(sources, bindings, core_api, root)
            if f["path"] == BINDINGS_PATH]


# --------------------------------------------------------------------------
# Counter / metrics parity

#: counter key -> owning registered series.  One owner per name; the
#: priority_jumps slot feeds the bucket-scheduler-owned overlap series.
NATIVE_SERIES_MAP: Dict[str, Optional[str]] = {
    "cycles": "hvd_native_cycles_total",
    "tensors": "hvd_native_tensors_total",
    "fused_tensors": "hvd_native_fused_tensors_total",
    "processed_bytes": "hvd_native_fused_bytes_total",
    "fusion_capacity": "hvd_native_fusion_buffer_capacity_bytes",
    "fusion_fill": "hvd_native_fusion_buffer_fill_bytes",
    "spans": "hvd_native_spans_total",
    "spans_dropped": "hvd_native_spans_dropped_total",
    "bucket_bytes": "hvd_native_bucket_bytes",
    "cache_hits": "hvd_native_cache_hits_total",
    "cache_misses": "hvd_native_cache_misses_total",
    "pipeline_depth": "hvd_native_pipeline_depth",
    "pipeline_stall_us": "hvd_native_pipeline_stall_seconds",
    "priority_jumps": "hvd_overlap_priority_jumps_total",
    "cycle_seconds": "hvd_native_cycle_seconds",
    "execute_seconds": "hvd_native_execute_seconds",
    "engine_gen": None,  # generation counter: consumed, not exported
}

#: ring-owned wire series that must stay pinned in test_metrics_lint.
RING_SERIES: Tuple[str, ...] = (
    "hvd_ring_wire_bytes_total",
    "hvd_ring_compress_seconds",
    "hvd_ring_chunk_bytes",
)

#: histogram-derived keys metrics consumes beyond the scalar block.
_HIST_KEYS = ("cycle_seconds", "execute_seconds")


def _metrics_consumed_keys(source: str) -> Dict[str, int]:
    """Counter keys the metrics mirror consumes from
    ``bindings.native_counters()``: literal ``c["key"]`` subscripts and
    ``_ctr(x, "key")``/``_hist(x, "key")`` helper calls inside
    ``refresh_native_engine_metrics``.  Returns ``{key: lineno}``."""
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "refresh_native_engine_metrics":
            fn = node
            break
    if fn is None:
        return {}
    # The counters dict is whatever name `bindings.native_counters()`
    # (or a bare `native_counters()`) is assigned to; subscripts on any
    # *other* dict (seen-baselines, histogram payloads) are not slot
    # consumption.
    ctr_names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = node.value.func
            cname = callee.attr if isinstance(callee, ast.Attribute) else \
                callee.id if isinstance(callee, ast.Name) else ""
            if cname == "native_counters":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        ctr_names.add(tgt.id)
    keys: Dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in ctr_names and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            keys.setdefault(node.slice.value, node.lineno)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("_ctr", "_hist") and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            keys.setdefault(node.args[1].value, node.lineno)
    return keys


def _registered_series(source: str) -> Dict[str, int]:
    """Registered metric names in a source file, via the same AST
    inventory the metric-catalog rule uses."""
    from .rules import MetricCatalogRule
    tree = ast.parse(source)
    return {name: node.lineno
            for name, node in MetricCatalogRule.registrations(tree)}


def _pinned_series(source: str) -> set:
    """String constants in the metrics-lint pin test — the known-series
    list every registered series must appear in."""
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "test_known_series_present":
            fn = node
            break
    if fn is None:
        return set()
    return {n.value for n in ast.walk(fn)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("hvd_")}


def counter_findings(sources: Dict[str, dict], bindings: dict,
                     root: Optional[str] = None) -> List[dict]:
    """Checker 2: counter-slot layout ↔ bindings mirror ↔ metrics
    consumption ↔ known-series pin, one owner per name."""
    root = root or _REPO_DIR
    findings: List[dict] = []
    engine = sources.get("engine")
    if engine is None:
        return findings
    counters = extract_counters(engine["code"])
    consts = bindings["constants"]
    rel_engine = engine["relpath"]

    scalars_py = consts.get("NATIVE_COUNTER_SCALARS")
    if not isinstance(scalars_py, tuple):
        findings.append(_finding(
            "counters", BINDINGS_PATH, 0,
            "NATIVE_COUNTER_SCALARS missing or not statically evaluable"))
        scalars_py = ()
    if list(scalars_py) != counters["scalars"]:
        findings.append(_finding(
            "counters", rel_engine, 0,
            "CounterSlot scalar block %s != bindings."
            "NATIVE_COUNTER_SCALARS %s (order and names must mirror "
            "exactly)" % (counters["scalars"], list(scalars_py))))
    if consts.get("NATIVE_HIST_BUCKETS") != counters["hist_buckets"]:
        findings.append(_finding(
            "counters", rel_engine, 0,
            "kHistBuckets=%s != bindings.NATIVE_HIST_BUCKETS=%s"
            % (counters["hist_buckets"], consts.get("NATIVE_HIST_BUCKETS"))))
    if consts.get("N_NATIVE_COUNTER_SLOTS") != counters["n_slots"]:
        findings.append(_finding(
            "counters", rel_engine, 0,
            "N_COUNTER_SLOTS=%s != bindings.N_NATIVE_COUNTER_SLOTS=%s"
            % (counters["n_slots"], consts.get("N_NATIVE_COUNTER_SLOTS"))))

    # -- metrics mirror consumes exactly the slots + histogram keys ------
    expected_keys = set(counters["scalars"]) | set(_HIST_KEYS) | \
        {"engine_gen"}
    try:
        metrics_src = _read(root, METRICS_PATH)
    except OSError:
        metrics_src = None
    if metrics_src is not None:
        consumed = _metrics_consumed_keys(metrics_src)
        for key in sorted(expected_keys - set(consumed)):
            findings.append(_finding(
                "counters", METRICS_PATH, 0,
                "counter slot %r is never consumed by "
                "refresh_native_engine_metrics — the mirror silently "
                "dropped it" % key))
        for key, line in sorted(consumed.items()):
            if key not in expected_keys:
                findings.append(_finding(
                    "counters", METRICS_PATH, line,
                    "metrics mirror consumes counter key %r which the C "
                    "layout does not define" % key))

        # -- every mapped series is registered, with one owner ------------
        registered = _registered_series(metrics_src)
        for key, series in sorted(NATIVE_SERIES_MAP.items()):
            if series is None or series == \
                    "hvd_overlap_priority_jumps_total":
                continue  # owned elsewhere; pin check below still applies
            if series not in registered:
                findings.append(_finding(
                    "counters", METRICS_PATH, 0,
                    "mapped series %s (counter %r) is not registered in "
                    "the metrics mirror" % (series, key)))
        native_like = {n for n in registered
                       if n.startswith(("hvd_native_", "hvd_ring_"))}
        mapped = {s for s in NATIVE_SERIES_MAP.values() if s} | \
            set(RING_SERIES)
        for series in sorted(native_like - mapped):
            findings.append(_finding(
                "counters", METRICS_PATH, registered[series],
                "registered native-mirror series %s has no owning "
                "counter slot in NATIVE_SERIES_MAP" % series))

    # -- the known-series pin covers the whole native mirror --------------
    try:
        pin_src = _read(root, METRICS_PIN_PATH)
    except OSError:
        pin_src = None
        findings.append(_finding(
            "counters", METRICS_PIN_PATH, 0,
            "the known-series pin file is missing: nothing holds the "
            "native mirror's series names"))
    if pin_src is not None:
        pinned = _pinned_series(pin_src)
        want_pinned = {s for s in NATIVE_SERIES_MAP.values() if s} | \
            set(RING_SERIES)
        for series in sorted(want_pinned - pinned):
            findings.append(_finding(
                "counters", METRICS_PIN_PATH, 0,
                "native-mirror series %s is not pinned in "
                "test_known_series_present" % series))
    return findings


def metrics_source_findings(source: str,
                            root: Optional[str] = None) -> List[dict]:
    """HVD011 entry point: counter-parity findings anchored in the
    metrics package source handed in (consumption direction only — the
    layout direction is abicheck's job and would anchor elsewhere)."""
    root = root or _REPO_DIR
    findings: List[dict] = []
    try:
        sources = load_sources(root)
        engine = sources.get("engine")
        bindings = parse_bindings(_read(root, BINDINGS_PATH))
    except OSError:
        return []
    if engine is None:
        return []
    counters = extract_counters(engine["code"])
    expected_keys = set(counters["scalars"]) | set(_HIST_KEYS) | \
        {"engine_gen"}
    consumed = _metrics_consumed_keys(source)
    for key, line in sorted(consumed.items()):
        if key not in expected_keys:
            findings.append(_finding(
                "counters", METRICS_PATH, line,
                "metrics mirror consumes counter key %r which the C "
                "layout does not define" % key))
    try:
        registered = _registered_series(source)
    except Exception:
        registered = {}
    mapped = {s for s in NATIVE_SERIES_MAP.values() if s} | set(RING_SERIES)
    for name, line in sorted(registered.items()):
        if name.startswith(("hvd_native_", "hvd_ring_")) and \
                name not in mapped:
            findings.append(_finding(
                "counters", METRICS_PATH, line,
                "registered native-mirror series %s has no owning "
                "counter slot in NATIVE_SERIES_MAP" % name))
    return findings


# --------------------------------------------------------------------------
# Manifest

def build_manifest(root: Optional[str] = None) -> dict:
    """The deterministic cross-language ABI manifest — the pinned
    source of truth ``--dump-manifest`` prints and the repo commits at
    ``.hvdabi-manifest.json``.  No line numbers, no timestamps: the
    manifest changes exactly when the contract changes."""
    root = root or _REPO_DIR
    sources = load_sources(root)
    bindings = parse_bindings(_read(root, BINDINGS_PATH))
    tf = sources.get("tf_ops")
    core_api = parse_core_api(tf["code_nc"], tf["code"]) if tf else \
        {"fields": {}, "symbols": {}}
    engine = sources.get("engine")
    counters = extract_counters(engine["code"]) if engine else {}
    anchors = parse_frame_anchors(engine["comments"]) if engine else []
    graph = lock_graph(sources)
    from . import protocol
    _findings, coverage = check_native_frames(
        engine["functions"] if engine else [], anchors, protocol.KINDS,
        engine["relpath"] if engine else "")
    return {
        "version": MANIFEST_VERSION,
        "exports": {
            name: {"tag": c["tag"], "ret": _norm_type(c["ret"]),
                   "args": [{"type": _norm_type(p["type"]),
                             "name": p["name"]} for p in c["params"]]}
            for name, c in sorted(exports(sources).items())},
        "bindings": {
            name: {"argtypes": d["argtypes"], "restype": d["restype"]}
            for name, d in sorted(bindings["decls"].items())},
        "core_api": {
            field: {"symbol": core_api["symbols"].get(field),
                    "ret": meta["ret"], "args": meta["args"]}
            for field, meta in sorted(core_api["fields"].items())},
        "counters": {
            "scalars": counters.get("scalars", []),
            "hist_buckets": counters.get("hist_buckets"),
            "hist_slots": counters.get("hist_slots"),
            "n_slots": counters.get("n_slots"),
        },
        "frame_kinds": coverage,
        "span_phases": extract_span_phases(engine["code"]) if engine else [],
        "lock_graph": {
            "locks": graph["locks"],
            "edges": sorted({(e["from"], e["to"])
                             for e in graph["edges"]}),
        },
    }


def render_manifest(manifest: dict) -> str:
    return json.dumps(manifest, indent=2, sort_keys=True) + "\n"


def manifest_findings(manifest: dict,
                      root: Optional[str] = None) -> List[dict]:
    """Compare the live manifest against the committed pin."""
    root = root or _REPO_DIR
    pin_path = os.path.join(root, MANIFEST_PATH)
    if not os.path.exists(pin_path):
        return [_finding(
            "manifest", MANIFEST_PATH, 0,
            "no committed manifest pin — run `python -m "
            "horovod_tpu_torch.tools.abicheck --write-manifest`")]
    with open(pin_path) as f:
        try:
            pinned = json.load(f)
        except ValueError as exc:
            return [_finding("manifest", MANIFEST_PATH, 0,
                             "manifest pin is not valid JSON: %s" % exc)]
    live = json.loads(render_manifest(manifest))
    if live == pinned:
        return []
    findings = []
    for section in sorted(set(live) | set(pinned)):
        a, b = pinned.get(section), live.get(section)
        if a == b:
            continue
        detail = ""
        if isinstance(a, dict) and isinstance(b, dict):
            changed = sorted(k for k in set(a) | set(b)
                             if a.get(k) != b.get(k))
            detail = " (changed keys: %s)" % ", ".join(changed[:8])
        findings.append(_finding(
            "manifest", MANIFEST_PATH, 0,
            "section %r drifted from the committed pin%s — if the "
            "change is intentional, regenerate with --write-manifest"
            % (section, detail)))
    return findings


# --------------------------------------------------------------------------
# One-call report

def run_checks(root: Optional[str] = None,
               with_manifest: bool = True) -> dict:
    """All hvdabi checkers in one pass.  Returns ``{findings, coverage,
    lock_graph, manifest, absent}``; ``findings`` is the flat list every
    CLI renders, ``absent`` the C++ sources missing from this tree (none
    in a whole checkout)."""
    root = root or _REPO_DIR
    sources = load_sources(root)
    bindings = parse_bindings(_read(root, BINDINGS_PATH))
    tf = sources.get("tf_ops")
    core_api = parse_core_api(tf["code_nc"], tf["code"]) if tf else \
        {"fields": {}, "symbols": {}}
    findings = abi_findings(sources, bindings, core_api, root)
    findings += counter_findings(sources, bindings, root)
    engine = sources.get("engine")
    coverage: dict = {}
    if engine is not None:
        from . import protocol
        anchors = parse_frame_anchors(engine["comments"])
        frame_f, coverage = check_native_frames(
            engine["functions"], anchors, protocol.KINDS,
            engine["relpath"])
        findings += frame_f
    graph = lock_graph(sources)
    from .lockorder import find_cycles
    cycles = find_cycles([(e["from"], e["to"]) for e in graph["edges"]])
    for cyc in cycles:
        findings.append(_finding(
            "locks", dict(CPP_SOURCES)["engine"], 0,
            "static C++ lock-order cycle: %s" % " -> ".join(cyc)))
    manifest = build_manifest(root)
    if with_manifest:
        findings += manifest_findings(manifest, root)
    return {
        "findings": findings,
        "coverage": coverage,
        "lock_graph": graph,
        "manifest": manifest,
        "absent": [relpath for tag, relpath in CPP_SOURCES
                   if tag not in sources],
    }
