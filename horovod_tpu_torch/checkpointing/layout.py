"""On-disk layout, integrity manifest, and commit protocol (a copy of
``horovod_tpu/checkpointing/layout.py``: the same files, names, format
tag and checks, so a checkpoint of either package is one of the other).

One checkpoint step is a directory::

    <root>/step_0000000042/
        shards/
            00000.full.bin          # leaf 0, unsharded
            00001.0.bin             # leaf 1, shard starting at row 0
            00001.8.bin             # leaf 1, shard starting at row 8
            index.0.json            # per-process shard table (multi-host)
        manifest.json               # step, world, per-leaf layout+checksums
        COMMIT                      # written LAST, atomic rename

Crash consistency comes from ordering, not locking:

1. every shard file is written to a ``.tmp`` sibling, fsync'd, renamed;
2. the manifest (which embeds every shard's CRC32) is written the same
   way, *after* all shards;
3. the ``COMMIT`` marker — carrying the manifest's own CRC32 — is
   renamed into place last, then the step directory is fsync'd.

Discovery (:func:`completed_steps`) therefore never has to trust a
half-written checkpoint: a new-format directory without ``COMMIT`` is a
crashed save and is skipped; a directory without ``manifest.json`` and
without ``shards/`` is a *legacy* (orbax) checkpoint whose own
rename-at-end protocol already implies completeness.
"""

import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional

#: manifest format tag; bump on incompatible layout changes
FORMAT = "hvd-tpu-ckpt-v1"

MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT"
SHARDS_DIR = "shards"

_STEP_RE = re.compile(r"^step_(\d+)$")

#: classification of a step directory
COMMITTED = "committed"     # new format, COMMIT marker present
PARTIAL = "partial"         # new format, crashed before COMMIT
LEGACY = "legacy"           # pre-manifest (orbax) checkpoint


class IntegrityError(RuntimeError):
    """A checkpoint failed verification: torn manifest, checksum
    mismatch, missing shard file. Distinct from FileNotFoundError (the
    step was never written) because the *caller's* remedy differs: an
    integrity failure is walk-back material, a missing step is a usage
    error."""


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """tmp + fsync + rename: readers see the old content or all of the
    new, never a torn write. The pid suffix keeps concurrent writers
    (two processes persisting the same replicated shard) from clobbering
    each other's temp file mid-write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # a failed write (ENOSPC, kill mid-write) must not strand the
        # temp file: long-lived jobs would accumulate one per attempt
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the containing directory (no-op on
    filesystems/platforms without directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def shard_filename(leaf_index: int, starts) -> str:
    """Deterministic shard file name from the shard's global offsets, so
    every process derives the same name for the same shard without
    coordination. Scalars / unsharded leaves get ``full``."""
    sig = "-".join(str(int(s)) for s in starts) if starts else "full"
    return f"{leaf_index:05d}.{sig}.bin"


# -- manifest ---------------------------------------------------------------

def write_manifest(path: str, manifest: Dict[str, Any]) -> int:
    """Atomically write ``manifest.json``; returns its CRC32 (embedded in
    the COMMIT marker so a torn manifest is detectable without parsing)."""
    data = json.dumps(manifest, indent=1, sort_keys=True).encode()
    atomic_write_bytes(os.path.join(path, MANIFEST_NAME), data)
    return crc32(data)


def read_manifest(path: str, verify_commit: bool = True) -> Dict[str, Any]:
    """Parse and verify a step directory's manifest.

    Raises :class:`IntegrityError` when the manifest is torn, fails the
    COMMIT marker's checksum, or carries an unknown format tag — and
    FileNotFoundError when there is no manifest at all (legacy dir)."""
    mpath = os.path.join(path, MANIFEST_NAME)
    with open(mpath, "rb") as f:
        data = f.read()
    if verify_commit:
        commit = read_commit(path)
        if commit is not None and commit.get("manifest_crc32") is not None \
                and commit["manifest_crc32"] != crc32(data):
            raise IntegrityError(
                f"manifest checksum mismatch under {path!r}: the COMMIT "
                f"marker does not vouch for this manifest")
    try:
        manifest = json.loads(data)
    except ValueError as e:
        raise IntegrityError(f"unparseable manifest under {path!r}") from e
    if manifest.get("format") != FORMAT:
        raise IntegrityError(
            f"unknown checkpoint format {manifest.get('format')!r} under "
            f"{path!r} (want {FORMAT!r})")
    return manifest


def write_commit(path: str, step: int, manifest_crc: int) -> None:
    """The point of no return: after this rename the step is discoverable."""
    data = json.dumps({"step": step, "manifest_crc32": manifest_crc}).encode()
    atomic_write_bytes(os.path.join(path, COMMIT_NAME), data)
    fsync_dir(path)


def read_commit(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, COMMIT_NAME), "rb") as f:
            return json.loads(f.read())
    except FileNotFoundError:
        return None
    except ValueError:
        # A torn COMMIT cannot happen under the rename protocol; treat it
        # as present-but-unverifiable rather than hiding the step.
        return {}


# -- discovery --------------------------------------------------------------

def classify(path: str) -> str:
    """COMMITTED / PARTIAL / LEGACY for one step directory."""
    entries = set()
    try:
        entries = set(os.listdir(path))
    except OSError:
        pass
    if COMMIT_NAME in entries:
        return COMMITTED
    if MANIFEST_NAME in entries or SHARDS_DIR in entries:
        return PARTIAL
    return LEGACY


def all_step_dirs(directory: str) -> List[int]:
    """Every step directory (any state), ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(s for name in names
                  if (s := parse_step(name)) is not None)


def completed_steps(directory: str) -> List[int]:
    """Step numbers safe to restore from, newest first. New-format dirs
    count only once COMMIT landed; legacy (orbax) dirs count as before —
    orbax's own tmp-dir rename protocol filters its crashed saves (the
    tmp names don't match the step pattern)."""
    out = [s for s in all_step_dirs(directory)
           if classify(step_dir(directory, s)) != PARTIAL]
    out.reverse()
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = completed_steps(directory)
    return steps[0] if steps else None
