"""Artifact getter: fetch task artifacts with checksum verification.

Reference: upstream client/getter/getter.go (go-getter HTTP/S3
download). Supports http(s) URLs and file:// / local paths; checksum format
``md5:<hex>`` or ``sha256:<hex>`` like go-getter's query parameter.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.parse
import urllib.request


class ArtifactError(Exception):
    pass


def get_artifact(source: str, dest_dir: str, checksum: str = "") -> str:
    """Download/copy ``source`` into ``dest_dir``; returns the local path.
    Verifies the checksum when given (getter.go:20-43)."""
    parsed = urllib.parse.urlparse(source)
    name = os.path.basename(parsed.path) or "artifact"
    dest = os.path.join(dest_dir, name)

    if parsed.scheme in ("http", "https"):
        try:
            with urllib.request.urlopen(source, timeout=30) as resp, open(
                dest, "wb"
            ) as out:
                shutil.copyfileobj(resp, out)
        except OSError as e:
            raise ArtifactError(f"failed to fetch {source}: {e}") from e
    elif parsed.scheme in ("", "file"):
        src_path = parsed.path if parsed.scheme == "file" else source
        try:
            shutil.copy(src_path, dest)
        except OSError as e:
            raise ArtifactError(f"failed to copy {source}: {e}") from e
    else:
        raise ArtifactError(f"unsupported artifact scheme {parsed.scheme!r}")

    if checksum:
        _verify_checksum(dest, checksum)
    os.chmod(dest, 0o755)
    return dest


def _verify_checksum(path: str, checksum: str) -> None:
    try:
        algo, want = checksum.split(":", 1)
    except ValueError:
        raise ArtifactError(f"invalid checksum format {checksum!r}")
    try:
        h = hashlib.new(algo)
    except ValueError:
        raise ArtifactError(f"unsupported checksum algorithm {algo!r}")
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    if h.hexdigest() != want.lower():
        raise ArtifactError(
            f"checksum mismatch for {path}: got {h.hexdigest()}, want {want}"
        )
