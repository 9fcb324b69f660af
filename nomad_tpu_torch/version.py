"""Version parsing and constraint matching for `version` constraints.

Implements the subset of hashicorp/go-version semantics the reference relies
on for the scheduler's version constraints (upstream scheduler/
feasible.go:405-446): versions like ``1.2.3``/``0.1.0-beta``, and
comma-separated constraint lists with operators ``=``, ``!=``, ``>``, ``>=``,
``<``, ``<=``, and pessimistic ``~>``.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)(?:-([0-9A-Za-z.\-]+))?(?:\+[0-9A-Za-z.\-]+)?$"
)
_CONSTRAINT_RE = re.compile(r"^\s*(~>|>=|<=|!=|=|>|<)?\s*(\S+)\s*$")


class Version:
    def __init__(self, segments: Tuple[int, ...], prerelease: str = ""):
        self.segments = segments
        self.prerelease = prerelease

    @property
    def padded(self) -> Tuple[int, int, int]:
        s = self.segments + (0,) * (3 - len(self.segments))
        return s[:3]

    def padded_to(self, n: int) -> Tuple[int, ...]:
        return self.segments + (0,) * (n - len(self.segments))

    def _cmp_key(self, width: int):
        # A pre-release sorts before the release it tags.
        return (self.padded_to(width), self.prerelease == "", self.prerelease)

    def __lt__(self, other: "Version") -> bool:
        width = max(len(self.segments), len(other.segments), 3)
        return self._cmp_key(width) < other._cmp_key(width)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Version):
            return NotImplemented
        width = max(len(self.segments), len(other.segments), 3)
        return (
            self.padded_to(width) == other.padded_to(width)
            and self.prerelease == other.prerelease
        )

    def __le__(self, other: "Version") -> bool:
        return self < other or self == other

    def __repr__(self) -> str:
        base = ".".join(str(s) for s in self.segments)
        return f"Version({base}{'-' + self.prerelease if self.prerelease else ''})"


def parse_version(s: str) -> Version:
    m = _VERSION_RE.match(s.strip())
    if not m:
        raise ValueError(f"malformed version: {s!r}")
    segments = tuple(int(p) for p in m.group(1).split("."))
    return Version(segments, m.group(2) or "")


class Constraint:
    def __init__(self, op: str, target: Version, target_segments: int):
        self.op = op
        self.target = target
        self.target_segments = target_segments

    def check(self, v: Version) -> bool:
        t = self.target
        if self.op in ("", "="):
            return v == t
        if self.op == "!=":
            return v != t
        if self.op == ">":
            return t < v
        if self.op == ">=":
            return t <= v
        if self.op == "<":
            return v < t
        if self.op == "<=":
            return v <= t
        if self.op == "~>":
            # Pessimistic: >= target, and the leading segments (all but the
            # last specified one) must match.
            if v < t:
                return False
            fixed = max(self.target_segments - 1, 1)
            return v.padded[:fixed] == t.padded[:fixed]
        raise ValueError(f"unknown constraint operator {self.op!r}")


def parse_constraints(s: str) -> List[Constraint]:
    out: List[Constraint] = []
    for part in s.split(","):
        m = _CONSTRAINT_RE.match(part)
        if not m:
            raise ValueError(f"malformed constraint: {part!r}")
        op = m.group(1) or "="
        target = parse_version(m.group(2))
        out.append(Constraint(op, target, len(target.segments)))
    return out


def check_version_constraint(version_str: str, constraint_str: str) -> bool:
    """Whether ``version_str`` satisfies every constraint in
    ``constraint_str``. Returns False on parse failure, mirroring
    checkVersionConstraint (feasible.go:405-446). Non-string inputs
    (a present-but-None node attribute) are parse failures, not crashes —
    the same posture as check_lexical_order/check_regexp_constraint."""
    if not isinstance(version_str, str) or not isinstance(constraint_str, str):
        return False
    try:
        v = parse_version(version_str)
        constraints = parse_constraints(constraint_str)
    except ValueError:
        return False
    return all(c.check(v) for c in constraints)
