"""Crash-consistent checkpoint I/O: the port of
``deeplearning4j_tpu/utils/atomic_io.py`` (temporary file, fsync, rename;
CRC-32 manifests).

Every checkpoint writer of the port (``utils/model_serializer.py``, the
non-finite guard's divergence checkpoint, ``fit(checkpoint_every=...)``)
commits through this module. The protocol, for a single file::

    write the payload to  <path>.tmp      (with a CRC-32 manifest)
    fsync(<path>.tmp)
    os.replace(<path>.tmp, <path>)        # the commit: atomic on POSIX
    fsync(dirname(<path>))                # persist the rename itself

and for a directory checkpoint the same shape, the payload files and
``manifest.json`` written inside ``<dir>.tmp`` and the directory rename
as the commit. A crash at any point leaves either the previous
checkpoint intact (before the rename) or the new one complete (after
it); a leftover ``*.tmp`` is uncommitted garbage that readers ignore and
the retention sweep deletes.

The manifest (``manifest.json``: a zip entry for archives, a file for
directories) maps each payload name to its CRC-32, so a restore detects
truncation and bit rot as a typed ``CheckpointCorruptError`` instead of a
raw zip or numpy error (``DL4J_TORCH_CKPT_VERIFY=0`` skips the CRC pass;
structural damage still raises). The manifest is the reference's, so an
archive written by either package passes the other's check.

Fault-injection sites (``testing/faults.py``):

- ``kill-during-ckpt`` fires between the temporary write and the rename:
  the process death the protocol exists for;
- ``corrupt-ckpt[truncate]`` / ``corrupt-ckpt[bitflip]`` damage the
  committed artifact right after the rename (param: the byte offset of
  the bit flip), as storage rot would.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_flag
from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.testing import faults

# every committed payload counts its bytes here; a commit's latency is
# recorded one level up, in utils/training_checkpoint.py
_OBS_CKPT_BYTES = obs.counter(
    "checkpoint.bytes_written_total",
    "Bytes committed through the atomic checkpoint write protocol")

__all__ = ["MANIFEST_NAME", "crc32", "write_bytes_atomic",
           "write_zip_atomic", "open_zip_verified", "read_zip_entries",
           "write_file", "commit_dir_atomic", "verify_dir_manifest",
           "recover_dir"]

MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1


def crc32(data):
    """Unsigned CRC-32 of a bytes payload (the manifest's checksum)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def _verify_enabled():
    return env_flag("DL4J_TORCH_CKPT_VERIFY")


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    """Persist a rename by fsyncing the containing directory (best effort:
    not every platform/filesystem allows directory fds)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_bytes(path, data, *, fsync=True):
    """Plain (non-committing) write used for files INSIDE a tmp directory,
    where the directory rename is the commit point."""
    with open(path, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())


def _fsync_tree(root):
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            try:
                _fsync_file(os.path.join(dirpath, name))
            except OSError:
                pass


def _corrupt(path, mode, spec):
    """Damage a committed artifact in place (fault injection only). For a
    directory checkpoint the largest payload file is the target —
    deterministic, and the most likely victim of real rot."""
    target = path
    if os.path.isdir(path):
        candidates = []
        for dirpath, _dirs, files in os.walk(path):
            for name in files:
                if name == MANIFEST_NAME:
                    continue
                p = os.path.join(dirpath, name)
                candidates.append((os.path.getsize(p), p))
        if not candidates:
            return
        target = max(candidates)[1]
    size = os.path.getsize(target)
    if size == 0:
        return
    with open(target, "r+b") as f:
        if mode == "truncate":
            f.truncate(max(0, size // 2))
        else:   # bitflip
            off = min(max(0, spec.param_int(size // 2)), size - 1)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x40]))


def _commit(tmp, final):
    """The commit point shared by file and directory checkpoints: fire the
    crash site, rename, persist the rename, then fire the rot sites."""
    if faults.fire("kill-during-ckpt") is not None:
        # simulated process death between tmp-write and rename: the tmp
        # artifact is left behind (uncommitted garbage), the previous
        # checkpoint at ``final`` is untouched
        raise RuntimeError(
            f"fault injected: kill-during-ckpt before renaming {tmp!r} "
            f"over {final!r}")
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(os.path.abspath(final)))
    for mode in ("truncate", "bitflip"):
        spec = faults.fire("corrupt-ckpt", qual=mode)
        if spec is not None:
            _corrupt(final, mode, spec)


def write_bytes_atomic(path, data):
    """Commit ``data`` to ``path`` via the tmp+fsync+rename protocol."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with obs.span("checkpoint.write", bytes=len(data)):
        _write_bytes(tmp, data)
        _commit(tmp, path)
    _OBS_CKPT_BYTES.inc(len(data))
    return path


def write_file(path, data):
    """Write a file WITHOUT its own commit (fsync only): for files inside
    a tmp directory whose commit is the directory rename. Text is encoded
    as UTF-8."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    _write_bytes(os.fspath(path), data)


def write_zip_atomic(path, entries):
    """Commit a checkpoint archive: ``entries`` ({name: bytes|str}) plus a
    CRC-32 manifest entry, written tmp-first and renamed into place."""
    entries = {name: (data.encode("utf-8") if isinstance(data, str)
                      else data)
               for name, data in entries.items()}
    manifest = {"version": _MANIFEST_VERSION,
                "payloads": {name: crc32(data)
                             for name, data in entries.items()}}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in entries.items():
            z.writestr(name, data)
        z.writestr(MANIFEST_NAME, json.dumps(manifest))
    return write_bytes_atomic(path, buf.getvalue())


def open_zip_verified(path):
    """Open a checkpoint archive for reading, verifying integrity first.

    Raises :class:`CheckpointCorruptError` on structural damage
    (truncation — the zip central directory lives at EOF), a payload whose
    CRC-32 disagrees with the manifest, or a manifest naming a missing
    entry. Archives written before the manifest era fall back to the zip
    format's own per-entry CRCs (``testzip``). ``DL4J_TORCH_CKPT_VERIFY=0``
    skips the content pass (structural damage still raises)."""
    path = os.fspath(path)
    try:
        z = zipfile.ZipFile(path, "r")
    except (zipfile.BadZipFile, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is not a readable archive (torn or "
            f"truncated write?): {e}") from e
    try:
        if not _verify_enabled():
            return z
        names = set(z.namelist())
        if MANIFEST_NAME in names:
            manifest = json.loads(z.read(MANIFEST_NAME).decode())
            for name, want in manifest.get("payloads", {}).items():
                if name not in names:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: manifest names payload "
                        f"{name!r} but the archive lacks it")
                if crc32(z.read(name)) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: payload {name!r} fails its "
                        "manifest CRC-32 (bit rot or partial overwrite)")
        else:
            bad = z.testzip()   # legacy manifest-less archive
            if bad is not None:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: payload {bad!r} fails the zip "
                    "CRC (legacy archive, no manifest)")
    except CheckpointCorruptError:
        z.close()
        raise
    except Exception as e:
        z.close()
        raise CheckpointCorruptError(
            f"checkpoint {path!r} failed verification: {e!r}") from e
    return z


def read_zip_entries(path, *, exclude=()):
    """All entries of a verified archive as {name: bytes} (the rewrite
    path for add_normalizer_to_model — read, modify, re-commit)."""
    with open_zip_verified(path) as z:
        return {name: z.read(name) for name in z.namelist()
                if name not in set(exclude) | {MANIFEST_NAME}}


# ---------------------------------------------------------------------------
# directory checkpoints
# ---------------------------------------------------------------------------

def _dir_payloads(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in sorted(files):
            if os.path.join(dirpath, name) == os.path.join(root,
                                                           MANIFEST_NAME):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            out[rel.replace(os.sep, "/")] = os.path.join(dirpath, name)
    return out


def recover_dir(path):
    """Crash recovery for the directory overwrite form: a real kill
    between the ``final -> .old`` swap and the ``tmp -> final`` rename
    leaves the previous checkpoint parked at ``<path>.old`` with nothing
    at ``path``. Readers call this first to roll the swap back — the
    protocol's previous-checkpoint-survives guarantee holds across that
    window too, not only up to the swap."""
    path = os.fspath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        os.replace(path + ".old", path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))


def commit_dir_atomic(tmp_dir, final_dir):
    """Commit a directory checkpoint: write the CRC manifest over every
    payload file in ``tmp_dir``, fsync the tree, and rename it to
    ``final_dir``. If ``final_dir`` already exists (the whole-directory
    save form overwrites) it is swapped out via a ``.old`` rename first;
    a crash inside that swap window is healed by :func:`recover_dir` on
    the next read or save, so no crash point leaves zero checkpoints
    behind."""
    import shutil
    payloads = {}
    nbytes = 0
    for rel, p in _dir_payloads(tmp_dir).items():
        with open(p, "rb") as fh:
            data = fh.read()
        nbytes += len(data)
        payloads[rel] = crc32(data)
    _write_bytes(os.path.join(tmp_dir, MANIFEST_NAME),
                 json.dumps({"version": _MANIFEST_VERSION,
                             "payloads": payloads}).encode())
    _fsync_tree(tmp_dir)
    old = None
    if os.path.isdir(final_dir):
        old = final_dir + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final_dir, old)
    try:
        _commit(tmp_dir, final_dir)
    except BaseException:
        if old is not None and not os.path.isdir(final_dir):
            os.replace(old, final_dir)   # crash pre-rename: restore prior
            old = None
        raise
    finally:
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    # counted only once the rename landed: the metric counts committed
    # bytes, and the kill-during-ckpt window must not inflate it
    _OBS_CKPT_BYTES.inc(nbytes)
    return final_dir


def verify_dir_manifest(path, *, missing_ok=False):
    """Verify a directory checkpoint against its manifest.

    A missing manifest raises (the atomic protocol always writes one, so
    its absence means an uncommitted/torn dir) unless ``missing_ok`` —
    the explicit-path restore forms pass it to accept pre-manifest legacy
    checkpoints — or verification is disabled; CRC mismatches and missing
    payloads raise regardless. Returns the payload map on success."""
    path = os.fspath(path)
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        if missing_ok or not _verify_enabled():
            return {}
        raise CheckpointCorruptError(
            f"checkpoint directory {path!r} has no {MANIFEST_NAME} — "
            "uncommitted (torn) write or pre-manifest legacy checkpoint")
    try:
        with open(mpath, "rb") as fh:
            manifest = json.loads(fh.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint directory {path!r}: unreadable manifest: "
            f"{e!r}") from e
    if not _verify_enabled():
        return manifest.get("payloads", {})
    for rel, want in manifest.get("payloads", {}).items():
        p = os.path.join(path, rel.replace("/", os.sep))
        if not os.path.isfile(p):
            raise CheckpointCorruptError(
                f"checkpoint directory {path!r}: manifest names payload "
                f"{rel!r} but it is missing")
        with open(p, "rb") as fh:
            if crc32(fh.read()) != want:
                raise CheckpointCorruptError(
                    f"checkpoint directory {path!r}: payload {rel!r} "
                    "fails its manifest CRC-32")
    return manifest.get("payloads", {})
