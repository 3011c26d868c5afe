"""Content-hash manifests of published directories (the JAX package's
``runtime/checkpoint.py`` manifest layer, copied): a directory is born
with ``ff_manifest.json`` — ``{"algo": "sha256", "files": {relpath:
{"sha256": ..., "bytes": n}}}`` — written inside its tmp dir before the
publish rename, and ``verify_dir_manifest`` recomputes it. Flight-recorder
bundles and the port's checkpoints use it. The format is
the JAX package's, so a bundle either package writes verifies in the
other."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

MANIFEST_NAME = "ff_manifest.json"


class CheckpointCorruptError(RuntimeError):
    """A published directory's payload no longer matches its content-hash
    manifest (torn write, bitrot, injected corruption)."""


def _manifest_files(step_dir: str):
    """Every regular file under `step_dir` except the manifest itself, as
    (relative posix path, absolute path) sorted for determinism."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, step_dir).replace(os.sep, "/")
            if rel == MANIFEST_NAME:
                continue
            out.append((rel, full))
    out.sort()
    return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class HashingWriter:
    """A binary file wrapper that hashes what is written through it, so a
    writer (``torch.save``) and the manifest share one pass over the
    bytes: ``digest()`` is the (sha256 hex, bytes) ``write_manifest``'s
    ``known`` takes."""

    def __init__(self, f):
        self.f = f
        self.h = hashlib.sha256()
        self.nbytes = 0

    def write(self, b) -> int:
        self.h.update(b)
        self.nbytes += len(b)
        return self.f.write(b)

    def flush(self):
        self.f.flush()

    def digest(self):
        return self.h.hexdigest(), self.nbytes


def write_manifest(step_dir: str, known: Optional[dict] = None) -> str:
    """Write the content-hash manifest of a (not yet published) directory;
    returns its path. ``known`` ({relpath: (sha256 hex, bytes)}) gives the
    digests of files hashed as they were written; a size that no longer
    matches the file is hashed again."""
    manifest = {"algo": "sha256", "files": {}}
    known = known or {}
    for rel, full in _manifest_files(step_dir):
        size = os.path.getsize(full)
        digest, nbytes = known.get(rel, (None, None))
        manifest["files"][rel] = {
            "sha256": digest if nbytes == size else _sha256(full),
            "bytes": size}
    path = os.path.join(step_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


def verify_dir_manifest(step_dir: str, label: Optional[str] = None,
                        require: bool = False):
    """Recompute the content-hash manifest of a published directory and
    raise ``CheckpointCorruptError`` naming the first mismatching file.
    Without a manifest: passes when ``require`` is False, raises when True
    (a flight bundle is born with its proof — one without is a torn
    write)."""
    label = label or step_dir
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        if require:
            raise CheckpointCorruptError(
                f"{label}: no {MANIFEST_NAME} — torn or foreign write")
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{label}: unreadable manifest {mpath}: {e}")
    files = manifest.get("files", {})
    present = {rel: full for rel, full in _manifest_files(step_dir)}
    missing = [rel for rel in files if rel not in present]
    if missing:
        raise CheckpointCorruptError(
            f"{label}: {len(missing)} manifest file(s) "
            f"missing, first {missing[0]!r}")
    for rel, rec in files.items():
        full = present[rel]
        if os.path.getsize(full) != rec.get("bytes"):
            raise CheckpointCorruptError(
                f"{label}: {rel!r} is "
                f"{os.path.getsize(full)} bytes, manifest records "
                f"{rec.get('bytes')}")
        if _sha256(full) != rec.get("sha256"):
            raise CheckpointCorruptError(
                f"{label}: content hash mismatch on {rel!r} "
                f"— payload corrupted after save")
