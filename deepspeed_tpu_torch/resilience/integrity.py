"""Checkpoint integrity: manifests, verification, fallback, pruning
(counterpart of ``deepspeed_tpu/resilience/integrity.py``; host-only, the
same functions and the same ``manifest.json``, so each package's
``verify_tag`` verifies the other's tags).

The commit protocol (``runtime/checkpoint/engine.py``) writes, in order:

1. the state files under ``<tag>/state`` (flushed and ``fsync``ed);
2. ``meta.json`` (config + step metadata);
3. ``manifest.json``: per-file sizes (+ sha256 at ``verify: "checksum"``)
   over everything under ``<tag>/state``, written LAST via atomic rename:
   its presence IS the commit marker;
4. the ``latest`` pointer flip.

A crash between (1) and (3) leaves a tag with no manifest: nothing points
at it, and load-time verification skips it. A crash between (3) and (4)
leaves a verified tag that ``latest`` does not name, which
``newest_verified_tag`` still finds for ``resume="auto"``. ``latest``
therefore never names a torn checkpoint.

Verification levels (``config.checkpoint.verify``):
- ``"off"``      — trust the directory;
- ``"size"``     — manifest present + every file exists at its recorded
                   size (catches torn/partial writes; default);
- ``"checksum"`` — additionally sha256 every file (catches bit rot; costs
                   a full read-back of the checkpoint at save AND load).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Optional

from ..utils.logging import log_dist, warning_once

MANIFEST = "manifest.json"
_CHUNK = 1 << 20


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _state_files(tag_dir: Path) -> list[Path]:
    state = tag_dir / "state"
    return sorted(p for p in state.rglob("*") if p.is_file())


def write_manifest(tag_dir: Path | str, level: str = "size",
                   extra: Optional[dict] = None) -> Optional[dict]:
    """Write ``<tag>/manifest.json`` over the already-durable state files.

    Call only AFTER the state write has committed (the async path calls it
    from ``wait_for_checkpoint``, after the writer thread ends). Atomic:
    written to a temp name and ``os.replace``d, so a reader never sees a
    half manifest. Returns the manifest dict, or None at ``level="off"``
    (no marker written)."""
    if level == "off":
        return None
    tag_dir = Path(tag_dir)
    files = {}
    for p in _state_files(tag_dir):
        rel = p.relative_to(tag_dir).as_posix()
        entry: dict = {"bytes": p.stat().st_size}
        if level == "checksum":
            entry["sha256"] = _sha256(p)
        files[rel] = entry
    manifest = {"version": 1, "tag": tag_dir.name, "level": level,
                "files": files, **(extra or {})}
    tmp = tag_dir / (MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, tag_dir / MANIFEST)
    return manifest


def verify_tag(tag_dir: Path | str, level: str = "size") -> tuple[str, str]:
    """Verify one tag directory against its manifest.

    Returns ``(status, reason)`` with status one of:
    - ``"verified"`` — manifest present and every check at ``level`` passed;
    - ``"legacy"``   — no manifest (a save that died before its commit, or
                       ``verify: "off"`` at save time);
    - ``"corrupt"``  — the manifest disagrees with the bytes on disk
                       (``reason`` names the first mismatch).
    """
    tag_dir = Path(tag_dir)
    if level == "off":
        return "verified", "verification off"
    mf = tag_dir / MANIFEST
    if not mf.exists():
        return "legacy", "no manifest (pre-resilience checkpoint?)"
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, ValueError) as e:
        return "corrupt", f"unreadable manifest: {e}"
    for rel, entry in manifest.get("files", {}).items():
        p = tag_dir / rel
        if not p.exists():
            return "corrupt", f"missing file {rel}"
        size = p.stat().st_size
        if size != entry["bytes"]:
            return "corrupt", (f"size mismatch {rel}: manifest "
                               f"{entry['bytes']} vs disk {size}")
        if level == "checksum":
            want = entry.get("sha256")
            if want is None:
                warning_once(
                    f"checkpoint verify=checksum but the manifest in "
                    f"{tag_dir} was written size-only — verifying sizes "
                    "for this tag (re-save to get checksums)")
            elif _sha256(p) != want:
                return "corrupt", f"checksum mismatch {rel}"
    return "verified", ""


def _tag_step(tag_dir: Path) -> int:
    """Ordering key for fallback/prune: the step recorded in meta.json
    (-1 for tags saved without one)."""
    meta = tag_dir / "meta.json"
    if meta.exists():
        try:
            return int(json.loads(meta.read_text()).get("global_steps", -1))
        except (OSError, ValueError):
            pass
    return -1


def list_tags(base: Path | str) -> list[Path]:
    """Tag directories under ``base``, oldest → newest (by recorded step,
    then mtime)."""
    base = Path(base)
    if not base.is_dir():
        return []
    tags = [d for d in base.iterdir() if d.is_dir() and (d / "state").exists()]
    return sorted(tags, key=lambda d: (_tag_step(d), d.stat().st_mtime))


def newest_verified_tag(base: Path | str, level: str = "size",
                        exclude: Optional[set] = None,
                        accept_legacy: bool = False) -> Optional[str]:
    """Newest tag under ``base`` that passes verification, or None.
    ``exclude`` skips tags already known bad (e.g. the one ``latest``
    named).

    ``accept_legacy=False`` (the default) also skips manifest-less tags: in
    a fallback scan a tag without its commit marker is far more likely a
    save that died mid-state-write than an old archive. (A legacy tag that
    ``latest`` names still loads, with a warning: the pointer is commit
    evidence the scan does not have.)"""
    exclude = exclude or set()
    for d in reversed(list_tags(base)):
        if d.name in exclude:
            continue
        status, reason = verify_tag(d, level)
        if status == "verified" or (status == "legacy" and accept_legacy):
            return d.name
        log_dist(f"checkpoint fallback: skipping {status} tag {d.name!r} "
                 f"({reason})", ranks=[0], level="WARNING")
    return None


def prune_tags(base: Path | str, keep_last: int,
               protect: Optional[set] = None) -> list[str]:
    """Delete the oldest tags beyond the newest ``keep_last``; never the
    ``protect``ed ones (the tag just written, and whatever ``latest``
    names). 0 disables. Returns the deleted tag names."""
    if keep_last <= 0:
        return []
    protect = protect or set()
    tags = list_tags(base)
    doomed = [d for d in tags[:-keep_last] if d.name not in protect] \
        if len(tags) > keep_last else []
    deleted = []
    for d in doomed:
        shutil.rmtree(d, ignore_errors=True)
        deleted.append(d.name)
    if deleted:
        log_dist(f"checkpoint: pruned {len(deleted)} old tag(s) "
                 f"(keep_last={keep_last}): {deleted}", ranks=[0])
    return deleted
