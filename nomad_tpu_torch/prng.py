"""Name-salted seeded PRNG streams: the project's ONE sanctioned source
of randomness in decision paths.

The pattern (born in faults.py, enforced tree-wide by nomadlint DET001):
every consumer owns a ``random.Random`` seeded from ``seed ^
crc32(name)``, so

- two streams with different names are independent — adding a draw at
  one site never shifts another site's decision sequence, and
- for a fixed seed the n-th draw of a named stream is the same run after
  run — the seed-replay contract SIMLOAD digests and fuzz families pin.

The process-global ``random`` module gives neither property: every
caller shares one cursor, so any new draw anywhere reorders everyone
else's decisions.
"""

from __future__ import annotations

import zlib
from random import Random


def salt(name: str) -> int:
    return zlib.crc32(name.encode())


def stream(seed: int, name: str) -> Random:
    """A seeded stream salted by ``name`` — independent per (seed, name)."""
    return Random(int(seed) ^ salt(name))


def fraction(name: str, *salts: object) -> float:
    """Stateless deterministic uniform-ish fraction in [0, 1) from a name
    plus salts — for jitter that must spread entities apart (heartbeat
    TTLs) without any stream state or draw-ordinal coupling."""
    h = zlib.crc32("|".join([name, *map(str, salts)]).encode())
    return h / 2**32
