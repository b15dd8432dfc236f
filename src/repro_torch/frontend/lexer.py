"""Tokenizer for the restricted CUDA-C subset (see package docstring).

Comments are stripped with newlines preserved so every token carries its
original 1-based source line - the currency of the frontend's
``UnsupportedKernel`` diagnostics.  A minimal preprocessor handles
object-like ``#define NAME value`` macros (the way Rodinia sources bake
in problem sizes); ``#include`` and other directives are ignored.
Macro values may reference earlier macros; expansion is iterative with a
depth cap so a cycle fails loudly instead of hanging.
"""
from __future__ import annotations

import re
from typing import NamedTuple

from repro_torch.core.kernel import UnsupportedKernel


class Token(NamedTuple):
    kind: str       # 'id' | 'int' | 'float' | 'punct' | 'eof'
    text: str
    line: int


#: multi-character operators, longest first so maximal munch wins
_MULTI = ("<<=", ">>=", "&&", "||", "<<", ">>", "<=", ">=", "==", "!=",
          "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "++", "--",
          "->")
_SINGLE = set("+-*/%<>=!&|^~?:;,()[]{}.")

_ID = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
#: floats need a dot or exponent; trailing f/F suffix is CUDA idiom
_FLOAT = re.compile(r"(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[fF]?")
_HEX = re.compile(r"0[xX][0-9a-fA-F]+[uUlL]*")
_INT = re.compile(r"\d+[uUlL]*")


def _strip_comments(src: str) -> str:
    out, i, n = [], 0, len(src)
    while i < n:
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j          # keep the newline
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise UnsupportedKernel(
                    f"unterminated /* comment at line "
                    f"{src.count(chr(10), 0, i) + 1}")
            out.append("\n" * src.count("\n", i, j + 2))
            i = j + 2
        else:
            out.append(src[i])
            i += 1
    return "".join(out)


def _tokenize_fragment(text: str, line: int) -> list[Token]:
    """Tokenize one directive-free fragment starting at ``line``."""
    toks: list[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c.isspace():
            i += 1
            continue
        m = _ID.match(text, i)
        if m:
            toks.append(Token("id", m.group(), line))
            i = m.end()
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            m = _HEX.match(text, i)
            if m:
                toks.append(Token("int", m.group().rstrip("uUlL"), line))
                i = m.end()
                continue
            m = _FLOAT.match(text, i)
            lit = m.group()
            if "." in lit or "e" in lit or "E" in lit or lit[-1] in "fF":
                toks.append(Token("float", lit, line))
            else:
                toks.append(Token("int", lit, line))
            i = m.end()
            continue
        for op in _MULTI:
            if text.startswith(op, i):
                toks.append(Token("punct", op, line))
                i += len(op)
                break
        else:
            if c in _SINGLE:
                toks.append(Token("punct", c, line))
                i += 1
            else:
                raise UnsupportedKernel(
                    f"line {line}: unexpected character {c!r}")
    return toks


def macro_names(src: str) -> set[str]:
    """The names ``#define``d in ``src`` (without expanding anything).

    Lets :func:`repro_torch.frontend.translate.translate` route each ``bind=``
    key to the right layer: macro names override the ``#define`` table in
    the lexer, everything else binds a scalar kernel parameter during
    translation (expanding a parameter name through the lexer would
    mangle its declaration).
    """
    names: set[str] = set()
    for raw in _strip_comments(src).split("\n"):
        stripped = raw.strip()
        if stripped.startswith("#") and \
                stripped[1:].strip().startswith("define"):
            rest = stripped[1:].strip()[len("define"):].strip()
            m = _ID.match(rest)
            if m:
                names.add(m.group())
    return names


def tokenize(src: str, defines: dict | None = None) -> list[Token]:
    """Lex ``src`` into tokens, expanding ``#define`` macros.

    ``defines`` overrides/extends the source's own ``#define`` table
    (values are Python ints/floats) - the hook ``translate(...,
    bind=...)`` uses to specialize a kernel, and the mistranslation the
    frontend gate's ``--inject`` self-test plants.
    """
    src = _strip_comments(src)
    macros: dict[str, list[Token]] = {}
    body_toks: list[Token] = []
    for ln, raw in enumerate(src.split("\n"), 1):
        stripped = raw.strip()
        if stripped.startswith("#"):
            parts = stripped[1:].strip()
            if parts.startswith("define"):
                rest = _tokenize_fragment(parts[len("define"):], ln)
                if not rest or rest[0].kind != "id":
                    raise UnsupportedKernel(
                        f"line {ln}: malformed #define")
                if rest[1:] and rest[1].text == "(" \
                        and rest[1].line == rest[0].line \
                        and raw.find("(") == raw.find(rest[0].text) \
                        + len(rest[0].text):
                    raise UnsupportedKernel(
                        f"line {ln}: function-like macros are out of "
                        f"subset (object-like #define only)")
                macros[rest[0].text] = rest[1:]
            # include/pragma/ifdef...: ignored, not part of the subset
            continue
        body_toks.extend(_tokenize_fragment(raw, ln))

    for name, value in (defines or {}).items():
        kind = "float" if isinstance(value, float) else "int"
        macros[name] = [Token(kind, repr(value), 0)]

    # iterative object-like expansion with a depth cap
    for _ in range(16):
        expanded, changed = [], False
        for t in body_toks:
            if t.kind == "id" and t.text in macros:
                expanded.extend(Token(m.kind, m.text, t.line)
                                for m in macros[t.text])
                changed = True
            else:
                expanded.append(t)
        body_toks = expanded
        if not changed:
            break
    else:
        raise UnsupportedKernel("macro expansion did not terminate "
                                "(recursive #define?)")

    last = body_toks[-1].line if body_toks else 1
    return body_toks + [Token("eof", "", last)]
