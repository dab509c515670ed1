"""Checkpoint save/load for the training engine (counterpart of
``deepspeed_tpu/runtime/checkpoint/engine.py``).

Layout per tag directory (the JAX package's, with the port's own state
files in place of its orbax store):

    <dir>/<tag>/state/master.safetensors  the fp32 master, one whole tensor
                                          a leaf under its name
    <dir>/<tag>/state/mu.safetensors      the first moments ((0,) for an
    <dir>/<tag>/state/nu.safetensors      unused slot), then the second
    <dir>/<tag>/state/scalars.json        step, the optimizer's count of
                                          applied updates, skipped steps,
                                          global steps, the loss scale
    <dir>/<tag>/meta.json                 config + model metadata (JAX keys)
    <dir>/<tag>/manifest.json             the commit marker, written LAST
                                          (resilience/integrity.py)
    <dir>/latest                          the tag pointer

The files are in the safetensors layout (``tensorfile.py``); each is
flushed and ``fsync``ed before the manifest is written. Commit protocol:
state → meta → manifest → ``latest``. A death anywhere in between leaves
``latest`` at the previous durable checkpoint, and a load falls back to
the newest VERIFIED tag if the one ``latest`` names is torn.

The state goes through host buffers the engine allocates once (pinned on
the card) and reuses for every save and load. A sync save copies the
state into them, writes and commits. An async save (``checkpoint.
async_save``) enqueues the copy on a side stream and returns; a writer
thread waits for the copy, then writes; the next optimizer update waits
for the copy too (the optimizers update the state in place), and
``wait_for_checkpoint``, the next save or the next load commits.

In a world of several ranks (or one, with a process group) the files are
the same, so any world size reads any tag. Under tensor or expert
parallelism (``model`` or ``expert`` above 1) each rank holds its cut of a
leaf: each ``(model, expert)`` coordinate writes its own files
(``state/master.model<m>.expert<e>.safetensors``), its cut of every leaf
whole over ZeRO, and a tag resumes in the same world shape only
(resharding to another ``tp`` is ROADMAP queue 1 item 4). Each group file
has one writer rank among the ranks that hold the same cut (master: the
first, mu: the second, nu: the third, modulo their number), and a cut
leaf is all-gathered to it one leaf at a time, so no rank holds the whole
unsharded state on its device; the gathered copies are synchronous, and an
async save's side stream carries only the whole leaves. Every rank checks
the tag's hash against the others' first (``tag_validation``), the ranks
agree on any write error, then rank 0 alone writes the manifest and flips
``latest``. A load resolves its tag on rank 0 (``auto_resume`` too) and
each rank reads only its own part of each leaf. Save, load and
``wait_for_checkpoint`` are collectives: every rank calls them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from ...comm import comm
from ...platform.mesh import AXIS_ORDER
from ...resilience import chaos
from ...resilience.guards import CheckpointIntegrityError
from ...resilience.integrity import (MANIFEST, list_tags, newest_verified_tag,
                                     prune_tags, verify_tag, write_manifest)
from ...utils.logging import log_dist, warning_once
from ...utils.roadmap import later
from ..loss_scaler import LossScaleState
from .tensorfile import (Layout, read_data, read_entry, read_layout,
                         write_file)

GROUPS = ("master", "mu", "nu")
SCALARS = "scalars.json"
FORMAT = "deepspeed_tpu_torch/1"     # meta.json "format": the port's files
# threads writing ranges of each state file at once
# (``chip_smoke.checkpoint_write_probe()``: three 6.23 GB files at 1.04 GB/s
# with 4 a file, 0.93 with 1, 0.97 with 16)
WRITE_THREADS = 4


def _groups(engine) -> dict:
    return {"master": engine.master, "mu": engine.opt_state.mu,
            "nu": engine.opt_state.nu}


def _sharded(engine) -> bool:
    return engine.layout is not None and engine.layout.sharded


def _file(engine, group: str) -> str:
    """``group``'s file name: one a ``(model, expert)`` coordinate under
    tensor or expert parallelism."""
    if not _sharded(engine):
        return f"{group}.safetensors"
    lay = engine.layout
    return f"{group}.model{lay.m}.expert{lay.e}.safetensors"


def _writer(engine, group: str) -> bool:
    """Whether this rank writes ``group``'s file: of the ranks that hold
    the same cut (the ``("data", "zero")`` line under tensor or expert
    parallelism, else the world), the group's own."""
    mesh = engine.mesh
    if not _sharded(engine):
        return GROUPS.index(group) % mesh.world == mesh.rank
    line = ("data", "zero")
    return GROUPS.index(group) % mesh.size(line) == mesh.index(line)


def _cut(engine, name: str, t: torch.Tensor):
    """How this rank's part ``t`` of leaf ``name`` (the master or a moment)
    is cut, None where it is whole (a (0,) placeholder moment is)."""
    cut = engine.plans[name].master
    return cut if cut is not None and t.numel() else None


def _full_shape(engine, name: str, t: torch.Tensor) -> tuple:
    return engine.plans[name].shape if _cut(engine, name, t) is not None \
        else tuple(t.shape)


def _scalars(engine) -> dict:
    ls = engine.loss_scale
    return {"step": int(engine.step), "count": int(engine.opt_state.count),
            "skipped_steps": int(engine.skipped_steps),
            "global_steps": int(engine.global_steps),
            "loss_scale": {"scale": float(ls.scale),
                           "good_steps": int(ls.good_steps),
                           "hysteresis": int(ls.hysteresis)}}


def _any_rank(engine, flag: bool) -> bool:
    """True on every rank if ``flag`` is True on any (a collective)."""
    if not engine.mesh.active:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=engine.device)
    return bool(comm.all_reduce(t, AXIS_ORDER, "max", mesh=engine.mesh))


def _on_rank0(engine, fn):
    """``fn()`` on rank 0, its result (or its exception) on every rank."""
    if not engine.mesh.active:
        return fn()
    import torch.distributed as dist

    box = [None]
    if engine.mesh.rank == 0:
        try:
            box[0] = (True, fn())
        except Exception as e:         # re-raised on every rank below
            box[0] = (False, e)
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


def _write_json(path: Path, obj) -> None:
    """Write ``obj`` as JSON and ``fsync`` it."""
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())


class HostState:
    """The host copy of the state this rank writes: per group one uint8
    buffer in its file's data layout (pinned for a card engine), each leaf
    a view. ``groups``: group -> leaf -> (dtype, whole shape)."""

    def __init__(self, groups: dict, pin: bool, files: dict):
        self.files = files
        self.layouts = {g: Layout.of(specs) for g, specs in groups.items()}
        self.data = {g: torch.empty(lay.data_bytes, dtype=torch.uint8,
                                    pin_memory=pin)
                     for g, lay in self.layouts.items()}
        self.views = {g: self.layouts[g].views(self.data[g])
                      for g in self.layouts}

    @property
    def nbytes(self) -> int:
        return sum(lay.file_bytes for lay in self.layouts.values())


def _specs(engine, group: dict) -> dict:
    return {k: (t.dtype, _full_shape(engine, k, t)) for k, t in group.items()}


def host_state(engine) -> HostState:
    """The engine's host buffers for the groups this rank writes (every
    group with no process group: loads use them too), allocated at its
    first save or load (the state's shapes never change)."""
    if engine._host_state is None:
        engine._host_state = HostState(
            {g: _specs(engine, d) for g, d in _groups(engine).items()
             if _writer(engine, g)}, pin=engine.device.type == "cuda",
            files={g: _file(engine, g) for g in GROUPS})
    return engine._host_state


def _snapshot(engine, hs: HostState, stream=None):
    """Copy the state into ``hs``: a cut leaf all-gathered (every rank
    takes part) and copied by its writer on the current stream; a whole
    leaf copied by its writer on ``stream`` (after the work already
    enqueued), returning the event that marks the copies' end, or on the
    current stream, synchronized, returning None."""
    groups = _groups(engine)
    cuda = engine.device.type == "cuda"
    current = torch.cuda.current_stream(engine.device) if cuda else None
    if stream is not None:
        stream.wait_stream(current)
    for g, d in groups.items():
        mine = g in hs.views
        for k in sorted(d):
            t = d[k].detach()
            cut = _cut(engine, k, t)
            if cut is not None:
                full = comm.all_gather(t, cut.axes, cut.dim, mesh=engine.mesh)
                if mine:
                    hs.views[g][k].copy_(full, non_blocking=cuda)
            elif mine and stream is not None:
                with torch.cuda.stream(stream):
                    t.record_stream(stream)
                    hs.views[g][k].copy_(t, non_blocking=True)
            elif mine:
                hs.views[g][k].copy_(t, non_blocking=cuda)
    if stream is None:
        if cuda:
            torch.cuda.synchronize(engine.device)
        return None
    stream.wait_stream(current)
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _write_state(state_dir: Path, hs: HostState, scalars) -> None:
    """This rank's group files (a thread each, each writing
    ``WRITE_THREADS`` ranges at once: the writes release the GIL) and, on
    rank 0, the scalars, all ``fsync``ed; the first error propagates."""
    with ThreadPoolExecutor(max_workers=max(1, len(hs.layouts))) as ex:
        futures = [ex.submit(write_file, state_dir / hs.files[g],
                             hs.layouts[g], hs.data[g], WRITE_THREADS)
                   for g in hs.layouts]
        for f in futures:
            f.result()
    if scalars is not None:
        _write_json(state_dir / SCALARS, scalars)


def _model_config_dict(model):
    """JSON-safe dump of the model's TransformerConfig (None if absent),
    the dtype by name (``"bfloat16"``), as the JAX package writes it."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or not dataclasses.is_dataclass(cfg):
        return None
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            continue
        out[f.name] = v
    return out


def _validate_tag(engine, tag: str) -> None:
    """Cross-process tag consistency (JAX ``_validate_tag``): every rank
    all-gathers every rank's hash of the tag, so all of them see a
    mismatch and fail (``"fail"``) or warn together; none is left alone in
    the save's collectives."""
    import hashlib

    mesh = engine.mesh
    mode = engine.config.checkpoint.tag_validation
    if mode == "ignore" or not mesh.active or mesh.world == 1:
        return
    mine = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4], "big")
    hashes = comm.all_gather(
        torch.tensor([mine], dtype=torch.int64, device=engine.device),
        AXIS_ORDER, mesh=mesh)
    if bool((hashes != hashes[0]).any()):
        msg = (f"checkpoint tag {tag!r} differs across processes (hash "
               "mismatch) — ranks would write inconsistent checkpoints")
        if mode == "fail":
            raise ValueError(msg)
        log_dist(f"WARNING: {msg}")


def _commit_tag(engine, base: Path, tag: str, global_steps: int) -> None:
    """The durable-commit epilogue, shared by the sync and async paths:
    rank 0 writes the manifest (the commit marker), flips ``latest``
    (atomically) and prunes old tags. The kill points bracket the window
    the crash test targets."""
    chaos.kill_point(chaos.KILL_AFTER_STATE_WRITE)
    if engine.mesh.rank != 0:
        return
    ck = engine.config.checkpoint
    write_manifest(base / tag, ck.verify,
                   extra={"global_steps": global_steps})
    chaos.kill_point(chaos.KILL_BEFORE_LATEST_FLIP)
    tmp = base / "latest.tmp"
    tmp.write_text(tag)
    os.replace(tmp, base / "latest")
    if ck.keep_last:
        prune_tags(base, int(ck.keep_last), protect={tag})


@dataclasses.dataclass
class _Pending:
    """An async save in flight: its writer thread and what it reports."""
    base: Path
    tag: str
    global_steps: int
    thread: threading.Thread
    t0: float
    error: Optional[BaseException] = None
    write_s: float = 0.0


def wait_for_checkpoint(engine) -> None:
    """Block until an in-flight async save is written, then write its
    manifest and flip ``latest``; a write error on any rank is raised here
    on every rank, and that tag is never committed."""
    p = engine._pending_save
    if p is None:
        return
    p.thread.join()
    engine._pending_save = None
    if _any_rank(engine, p.error is not None):
        raise RuntimeError(
            f"async checkpoint write of {p.tag!r} failed: "
            f"{p.error if p.error is not None else 'on another rank'}") \
            from p.error
    t = time.perf_counter()
    _commit_tag(engine, p.base, p.tag, p.global_steps)
    engine.last_checkpoint_timing.update(
        write_s=p.write_s, manifest_s=time.perf_counter() - t,
        commit_s=time.perf_counter() - p.t0)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None) -> str:
    """Save the whole training state under ``<save_dir>/<tag>`` (default
    ``global_step<N>``); returns the tag's path. ``engine.
    last_checkpoint_timing`` holds its phases' seconds and this rank's
    bytes."""
    tag = tag or f"global_step{engine.global_steps}"
    _validate_tag(engine, tag)
    base = Path(save_dir).absolute()
    path = base / tag
    is_async = bool(engine.config.checkpoint.async_save)
    rank0 = engine.mesh.rank == 0
    wait_for_checkpoint(engine)            # one save in flight at a time
    t0 = time.perf_counter()
    hs = host_state(engine)
    t_alloc = time.perf_counter()
    scalars = _scalars(engine)
    (path / "state").mkdir(parents=True, exist_ok=True)
    if rank0:
        (path / MANIFEST).unlink(missing_ok=True)   # re-saving uncommits
    stream = None
    if is_async and engine.device.type == "cuda":
        if engine._ckpt_stream is None:
            engine._ckpt_stream = torch.cuda.Stream(engine.device)
        stream = engine._ckpt_stream
    event = _snapshot(engine, hs, stream)
    engine._snapshot_event = event
    t_copy = time.perf_counter()
    if rank0:
        _write_json(path / "meta.json", {
            "tag": tag,
            "global_steps": engine.global_steps,
            "config": engine.config.to_dict(),
            "param_count": engine.param_count,
            "mesh": dict(engine.mesh.shape),
            # lets dstpu_torch_to_fp32 (and JAX's model_config_from_meta)
            # rebuild the model config without the engine
            "model_config": _model_config_dict(engine.model),
            "layout": "device",
            "format": FORMAT,
        })
    mine = scalars if rank0 else None
    timing = {"bytes": hs.nbytes, "alloc_s": t_alloc - t0,
              "d2h_s": t_copy - t_alloc, "async": is_async}
    engine.last_checkpoint_timing = timing
    if is_async:
        pending = _Pending(base, tag, scalars["global_steps"], None, t0)

        def writer():
            t = time.perf_counter()
            try:
                if event is not None:
                    event.synchronize()
                _write_state(path / "state", hs, mine)
            except BaseException as e:     # re-raised by wait_for_checkpoint
                pending.error = e
            pending.write_s = time.perf_counter() - t

        pending.thread = threading.Thread(
            target=writer, name=f"checkpoint-writer-{tag}")
        pending.thread.start()
        engine._pending_save = pending
        timing["blocking_s"] = time.perf_counter() - t0
    else:
        t = time.perf_counter()
        error = None
        try:
            _write_state(path / "state", hs, mine)
        except Exception as e:             # every rank raises below
            error = e
        if _any_rank(engine, error is not None):
            raise RuntimeError(
                f"checkpoint write of {tag!r} failed: "
                f"{error if error is not None else 'on another rank'}") \
                from error
        t_write = time.perf_counter()
        _commit_tag(engine, base, tag, scalars["global_steps"])
        timing.update(write_s=t_write - t,
                      manifest_s=time.perf_counter() - t_write,
                      total_s=time.perf_counter() - t0)
    log_dist(f"saved checkpoint {path}"
             + (" (async, committing in background)" if is_async else ""),
             ranks=[0])
    return str(path)


def _resolve_verified_tag(engine, base: Path, tag: Optional[str]) -> str:
    """The tag to restore: ``latest`` (or the explicit ``tag``), verified
    against its manifest; on corruption fall back to the newest tag that
    does verify. A pinned tag never falls back: restoring another
    checkpoint than the one the caller named would be worse than failing."""
    level = engine.config.checkpoint.verify
    explicit = tag is not None
    if tag is None:
        latest = base / "latest"
        if latest.exists():
            tag = latest.read_text().strip()
        else:
            tag = newest_verified_tag(base, level)
            if tag is None:
                raise FileNotFoundError(
                    f"no 'latest' tag file and no loadable tag in {base}")
            log_dist(f"load_checkpoint: no 'latest' pointer in {base}; "
                     f"using newest verified tag {tag!r}", ranks=[0],
                     level="WARNING")
    status, reason = verify_tag(base / tag, level)
    if status == "legacy":
        warning_once(f"checkpoint {tag!r} has no integrity manifest — "
                     "loading unverified; re-save to get crash-safe commits")
    elif status == "corrupt":
        if explicit:
            raise CheckpointIntegrityError(
                f"checkpoint tag {tag!r} failed verification ({reason}); "
                "refusing to restore a pinned tag from torn bytes",
                tag=tag, reason=reason)
        fb = newest_verified_tag(base, level, exclude={tag})
        if fb is None:
            raise CheckpointIntegrityError(
                f"checkpoint {tag!r} failed verification ({reason}) and no "
                f"older verified tag exists in {base}", tag=tag,
                reason=reason)
        log_dist(f"load_checkpoint: tag {tag!r} failed verification "
                 f"({reason}) — falling back to newest verified tag {fb!r}",
                 ranks=[0], level="WARNING")
        tag = fb
    return tag


def _check_tag_format(engine, path: Path, meta: dict) -> None:
    """Refuse what the port cannot read: the offload engine's host layout,
    a tag of another tensor / expert-parallel shape, and a tag of the JAX
    package (an orbax store)."""
    if meta.get("layout") == "host":
        raise NotImplementedError(
            f"checkpoint {path} holds the offload engine's host layout; "
            f"ZeRO-Offload is not ported yet: {later(6, 'b')}")
    saved = meta.get("mesh") or {}
    here = engine.mesh.shape
    if any(int(saved.get(a, 1)) != here[a] for a in ("model", "expert")):
        raise NotImplementedError(
            f"checkpoint {path} was saved at mesh.model="
            f"{saved.get('model', 1)}, mesh.expert={saved.get('expert', 1)}"
            f"; this engine runs {here['model']} / {here['expert']}. "
            f"Resharding a tag across tensor or expert parallelism is not "
            f"ported yet: {later(4)}")
    missing = [g for g in GROUPS
               if not (path / "state" / _file(engine, g)).exists()]
    if missing or not (path / "state" / SCALARS).exists():
        raise ValueError(
            f"checkpoint {path} was not written by deepspeed_tpu_torch (no "
            f"state/{{master,mu,nu}}.safetensors; a JAX package tag is an "
            "orbax store). Two ways across: convert its master with the "
            "JAX package's dstpu_to_fp32 --format safetensors and pass "
            "models.read_fp32_safetensors(path, cfg) to initialize(params=)"
            "; or restore its TrainState on the JAX side and carry it into "
            "this engine with models.train_state_from_jax(state, engine)")


def _check_entries(path: Path, g: str, layout: Layout, want: dict) -> None:
    """``want``: leaf -> (dtype, whole shape)."""
    got = set(layout.entries)
    if got != set(want):
        raise ValueError(f"checkpoint {path}: {g} has leaves missing "
                         f"{sorted(set(want) - got)}, unexpected "
                         f"{sorted(got - set(want))}")
    for k, (dtype, shape) in want.items():
        e = layout.entries[k]
        if e.dtype != dtype or e.shape != shape:
            raise ValueError(
                f"checkpoint {path}: {g}/{k} is {e.dtype} {e.shape}, this "
                f"engine holds {dtype} {shape} (another model or "
                "optimizer?)")


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None) -> str:
    """Restore the whole training state from ``<load_dir>/<tag>`` (default:
    what ``latest`` names, verified, with fallback, as rank 0 resolves it)
    into the engine's tensors in place, each rank its own part of each
    leaf; returns the tag's path."""
    wait_for_checkpoint(engine)        # an in-flight save must commit first
    base = Path(load_dir).absolute()
    tag = _on_rank0(engine, lambda: _resolve_verified_tag(engine, base, tag))
    _validate_tag(engine, tag)
    path = base / tag
    meta_file = path / "meta.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    _check_tag_format(engine, path, meta)
    t0 = time.perf_counter()
    groups = _groups(engine)
    layouts = {}
    for g, d in groups.items():
        layouts[g] = read_layout(path / "state" / _file(engine, g))
        _check_entries(path, g, layouts[g], _specs(engine, d))
    cuda = engine.device.type == "cuda"
    if engine.mesh.active:
        # one leaf at a time: its bytes, this rank's part, onto the device
        t_alloc = time.perf_counter()
        with torch.no_grad():
            for g, d in groups.items():
                for k, t in d.items():
                    full = read_entry(path / "state" / _file(engine, g),
                                      layouts[g], k)
                    t.copy_(full if _cut(engine, k, t) is None
                            else engine.shard_of(k, full))
    else:
        hs = host_state(engine)
        t_alloc = time.perf_counter()
        for g, lay in layouts.items():
            if lay.header != hs.layouts[g].header:
                raise ValueError(f"checkpoint {path}: state/{g}.safetensors "
                                 "is not laid out as this engine writes it")
        with ThreadPoolExecutor(max_workers=len(GROUPS)) as ex:
            futures = {g: ex.submit(read_data,
                                    path / "state" / _file(engine, g),
                                    layouts[g], hs.data[g]) for g in GROUPS}
            for g in GROUPS:            # each group's copy once it is read
                futures[g].result()
                with torch.no_grad():
                    for k, t in groups[g].items():
                        t.copy_(hs.views[g][k], non_blocking=cuda)
    if cuda:
        torch.cuda.synchronize(engine.device)
    s = json.loads((path / "state" / SCALARS).read_text())
    engine.step = int(s["step"])
    engine.opt_state.count = int(s["count"])
    engine.skipped_steps = int(s["skipped_steps"])
    engine.global_steps = int(meta.get("global_steps", s["global_steps"]))
    ls = s["loss_scale"]
    engine.loss_scale = LossScaleState(float(ls["scale"]),
                                       int(ls["good_steps"]),
                                       int(ls["hysteresis"]))
    # re-baseline the non-finite sentinel: the restored skipped_steps is
    # the run's history, not a fresh all-skipped window
    engine._skipped_total_prev = float(engine.skipped_steps)
    engine._bad_step_streak = 0
    nbytes = sum((path / "state" / _file(engine, g)).stat().st_size
                 for g in GROUPS)
    engine.last_checkpoint_timing = {"load_s": time.perf_counter() - t0,
                                     "alloc_s": t_alloc - t0,
                                     "read_copy_s": time.perf_counter()
                                     - t_alloc, "bytes": nbytes}
    log_dist(f"loaded checkpoint {path} (step {engine.global_steps})",
             ranks=[0])
    return str(path)


def auto_resume(engine, load_dir: Optional[str]) -> Optional[str]:
    """``resilience.resume == "auto"``: restore the newest loadable
    checkpoint under ``load_dir`` if it holds any, else start fresh.
    Returns the restored path or None (fresh run), so a restart and a
    first launch are the same construction. Rank 0 decides for every
    rank."""
    if not load_dir:
        raise ValueError(
            'resilience.resume == "auto" requires resilience.resume_dir '
            "(the directory save_checkpoint writes to)")
    base = Path(load_dir).absolute()
    if _on_rank0(engine, lambda: not base.is_dir() or not list_tags(base)):
        log_dist(f"auto-resume: no checkpoints in {base} — fresh run",
                 ranks=[0])
        return None
    try:
        return load_checkpoint(engine, str(base))
    except FileNotFoundError as e:
        # tag dirs exist but none is committed (the run's first save died
        # mid-write): there was never a durable checkpoint to lose
        log_dist(f"auto-resume: no committed checkpoint in {base} ({e}) — "
                 "fresh run", ranks=[0], level="WARNING")
        return None
