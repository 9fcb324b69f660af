"""Minimal HCL (v1) parser for job specifications.

Covers the dialect the reference jobspec uses (upstream jobspec/
test-fixtures/*.hcl): blocks with string labels, assignments of strings,
numbers, booleans, and lists, nested blocks, and ``#``, ``//``, ``/* */``
comments. Produces a Body of Assign/Block items preserving repetition and
order (the jobspec merges repeated ``meta`` blocks like the reference).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union


class HCLParseError(Exception):
    def __init__(self, message: str, line: int):
        super().__init__(f"line {line}: {message}")
        self.line = line


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<newline>\n)
  | (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<block_comment>/\*.*?\*/)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<heredoc><<-?(?P<hd_tag>\w+)\n.*?\n\s*(?P=hd_tag))
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
  | (?P<punct>[{}\[\]=,])
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "r": "\r"}


@dataclass
class _Token:
    kind: str
    value: Any
    line: int


def _tokenize(text: str) -> List[_Token]:
    tokens: List[_Token] = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise HCLParseError(f"unexpected character {text[pos]!r}", line)
        kind = m.lastgroup
        raw = m.group(0)
        if kind == "newline":
            line += 1
        elif kind in ("ws", "comment"):
            pass
        elif kind == "block_comment":
            line += raw.count("\n")
        elif kind == "string":
            value = _unescape(raw[1:-1], line)
            tokens.append(_Token("string", value, line))
        elif kind == "heredoc":
            body = raw.split("\n", 1)[1]
            body = body.rsplit("\n", 1)[0]
            tokens.append(_Token("string", body, line))
            line += raw.count("\n")
        elif kind == "number":
            num = float(raw) if "." in raw else int(raw)
            tokens.append(_Token("number", num, line))
        elif kind == "ident":
            if raw == "true":
                tokens.append(_Token("bool", True, line))
            elif raw == "false":
                tokens.append(_Token("bool", False, line))
            else:
                tokens.append(_Token("ident", raw, line))
        elif kind == "punct":
            tokens.append(_Token(raw, raw, line))
        pos = m.end()
    return tokens


def _unescape(s: str, line: int) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            i += 1
            if i >= len(s):
                raise HCLParseError("dangling escape", line)
            out.append(_ESCAPES.get(s[i], s[i]))
        else:
            out.append(c)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Assign:
    key: str
    value: Any


@dataclass
class Block:
    type: str
    labels: List[str]
    body: "Body"


@dataclass
class Body:
    items: List[Union[Assign, Block]] = field(default_factory=list)

    def get(self, key: str, default: Any = None) -> Any:
        for item in self.items:
            if isinstance(item, Assign) and item.key == key:
                default = item.value
        return default

    def has(self, key: str) -> bool:
        return any(
            isinstance(item, Assign) and item.key == key for item in self.items
        )

    def assigns(self) -> dict:
        out = {}
        for item in self.items:
            if isinstance(item, Assign):
                out[item.key] = item.value
        return out

    def blocks(self, block_type: str) -> List[Block]:
        return [
            item
            for item in self.items
            if isinstance(item, Block) and item.type == block_type
        ]

    def merged_map(self, block_type: str) -> dict:
        """Merge repeated blocks' assignments (the reference iterates meta
        blocks and merges, parse.go:130-142)."""
        out: dict = {}
        for block in self.blocks(block_type):
            out.update(block.body.assigns())
        return out


class _Parser:
    def __init__(self, tokens: List[_Token]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[_Token]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> _Token:
        tok = self.peek()
        if tok is None:
            last_line = self.tokens[-1].line if self.tokens else 1
            raise HCLParseError("unexpected end of input", last_line)
        self.pos += 1
        return tok

    def expect(self, kind: str) -> _Token:
        tok = self.next()
        if tok.kind != kind:
            raise HCLParseError(f"expected {kind}, got {tok.kind}", tok.line)
        return tok

    def parse_body(self, until: Optional[str]) -> Body:
        body = Body()
        while True:
            tok = self.peek()
            if tok is None:
                if until is None:
                    return body
                raise HCLParseError(f"expected {until!r}", self.tokens[-1].line)
            if until is not None and tok.kind == until:
                self.next()
                return body
            body.items.append(self.parse_item())

    def parse_item(self) -> Union[Assign, Block]:
        key_tok = self.next()
        if key_tok.kind not in ("ident", "string"):
            raise HCLParseError(
                f"expected identifier, got {key_tok.kind}", key_tok.line
            )
        key = key_tok.value

        tok = self.peek()
        if tok is None:
            raise HCLParseError("unexpected end after key", key_tok.line)

        if tok.kind == "=":
            self.next()
            # `key = {` object assignment is treated as a block
            if (nxt := self.peek()) is not None and nxt.kind == "{":
                self.next()
                return Block(key, [], self.parse_body("}"))
            return Assign(key, self.parse_value())

        # Block: optional string labels then {
        labels: List[str] = []
        while tok is not None and tok.kind == "string":
            labels.append(self.next().value)
            tok = self.peek()
        if tok is None or tok.kind != "{":
            raise HCLParseError(
                f"expected '{{' after block header {key!r}",
                tok.line if tok else key_tok.line,
            )
        self.next()
        return Block(key, labels, self.parse_body("}"))

    def parse_value(self) -> Any:
        tok = self.next()
        if tok.kind in ("string", "number", "bool"):
            return tok.value
        if tok.kind == "[":
            values = []
            while True:
                nxt = self.peek()
                if nxt is None:
                    raise HCLParseError("unterminated list", tok.line)
                if nxt.kind == "]":
                    self.next()
                    return values
                values.append(self.parse_value())
                nxt = self.peek()
                if nxt is not None and nxt.kind == ",":
                    self.next()
        raise HCLParseError(f"unexpected value token {tok.kind}", tok.line)


def parse(text: str) -> Body:
    return _Parser(_tokenize(text)).parse_body(until=None)
