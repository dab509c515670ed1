"""deepspeed_tpu_torch's KV tiers under the paged ServingEngine
(serving/tiering.py, serving/hostkv.py, the pool's tier seams and clock in
serving/pages.py, ops/aio.py over ops/csrc/aio.cpp) against the JAX
package's, on the CPU in fp32.

Oracles:
- the prefix hashes that key every tier entry equal JAX's;
- store parity: both packages' ``HostKVTier`` / ``NVMeKVTier`` /
  ``TieringEngine`` driven through the same call sequences on the same
  numpy tiles under the same stepped clock (put, match, consume, release,
  LRU prunes under pins, collisions, ``peek_blocks``, torn, corrupt and
  lost files, a lost write, spill chains, the cap at the bottom rung, owner
  bytes): entries, keys, CRCs, payloads, snapshots and the metrics
  registries equal call for call. One count differs on purpose: after a
  torn read the JAX package's aio wait raises at every later wait (its
  library's error count is cumulative), so its ``aio_errors`` counts the
  next read again; the port's wait raises for the errors that are new
  since the last wait;
- the native aio library: built by g++ from the checkout, round-trips
  buffers, counts a failed transfer once, reports O_DIRECT; without g++
  it raises (no Python I/O path exists);
- the pool: ``PagePool`` with a host tier and a stepped clock through one
  scripted sequence (evictions that demote, admissions that restore, a
  deferred admission releasing its pins, demote-ahead candidates, the
  clock's ages): equal to the JAX pool's;
- the engine: greedy fp32 ``tiny_test`` at page size 8 on a one-request
  pool, two sessions alternating (every resume finds its prefix evicted):
  the port's tier-on tokens equal JAX's tier-on tokens, the port's
  tier-off tokens and solo ``generate()``, exactly; the tier counters
  (demotes, restores, restored pages and tokens, hits, misses, prunes,
  spills, fallbacks, bytes) equal JAX's, host rung alone and with the disk
  rung; the entries' keys and token tuples equal JAX's and their fp32
  tiles agree within 1e-5 of max |tile|; with int8 KV the tokens equal
  JAX's; a restored block's bytes in the prefill cache equal its pool
  page's before the eviction;
- demote-ahead under a stepped clock: the staged sets, the fast-frees and
  a zero demote wait equal JAX's (``tests/unit/test_demote_ahead.py``);
- degradation: a corrupt host copy is counted and recomputed, a tier too
  small for a page recomputes;
- no leaks after 10x oversubscription churn; the tier off by default;
  the config's validation raises as JAX's does.
"""

import os
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.observability.workload import prefix_hashes as jax_hashes
from deepspeed_tpu.observability.workload import token_hash as jax_hash
from deepspeed_tpu.serving import PagePool as JaxPagePool
from deepspeed_tpu.serving.hostkv import HostKVTier as JaxHostKVTier
from deepspeed_tpu.serving.tiering import NVMeKVTier as JaxNVMeKVTier
from deepspeed_tpu.serving.tiering import TieringEngine as JaxTieringEngine
from deepspeed_tpu.serving.tiering import tiles_crc as jax_crc
from deepspeed_tpu_torch.inference.config import ServingConfig
from deepspeed_tpu_torch.observability.metrics import MetricsRegistry
from deepspeed_tpu_torch.observability.workload import (prefix_hashes,
                                                        token_hash)
from deepspeed_tpu_torch.ops import aio, builder
from deepspeed_tpu_torch.serving import PagePool, ServingEngine
from deepspeed_tpu_torch.serving.hostkv import HostKVTier, PinnedPages
from deepspeed_tpu_torch.serving.pages import _page_split
from deepspeed_tpu_torch.serving.tiering import (NVMeKVTier, TieringEngine,
                                                 tiles_crc)

from test_torch_model import make_pair  # a test module of this directory
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_tick_clock import TickClock

PS = 8          # page size
P = 32          # prompt length: 4 full blocks
MAX_NEW = 8
M = 64          # slot capacity
POOL = 1 + (P + MAX_NEW - 1 + PS - 1) // PS   # one request's worst case
HOST = 8 << 20
EOS = 7
PAGE_NBYTES = 2 * 2 * PS * 64 * 4   # tiny_test: layers x (k, v) x PS x d x 4
TILE_SHARE = 1e-5


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PORT = _Pkg(host=HostKVTier, nvme=NVMeKVTier, engine=TieringEngine,
            registry=MetricsRegistry, crc=tiles_crc, pool=PagePool)
JAX = _Pkg(host=JaxHostKVTier, nvme=JaxNVMeKVTier, engine=JaxTieringEngine,
           registry=JaxRegistry, crc=jax_crc, pool=JaxPagePool)


def _tiles(seed=0, nbytes=256):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-4, 4, (nbytes // 2,)).astype(np.int8),
            "v": rng.standard_normal(nbytes // 8).astype(np.float32)}


def _norm(x, drop=()):
    """A log made comparable: arrays as (dtype, shape, bytes), the keys in
    ``drop`` and the port-only ``o_direct`` report left out."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _norm(v, drop) for k, v in x.items()
                if k not in drop and k != "o_direct"}
    if isinstance(x, (list, tuple)):
        return [_norm(v, drop) for v in x]
    return x


def _consumed(result):
    """A ``consume`` result with each tile's per-block arrays (the port's
    payload) stacked on axis 1, as the JAX package returns them."""
    tiles, nbytes, tokens = result
    return ({k: np.stack(v, axis=1) if isinstance(v, list) else v
             for k, v in tiles.items()}, nbytes, tokens)


def _state(tier):
    """A store's entries (key, tokens, CRC, pin, bytes, owner, whether its
    tiles are in memory) and snapshot."""
    return [[(k, e["tokens"], e["crc"], e["pinned"], e["nbytes"],
              e["owner"], e["tiles"] is None)
             for k, e in tier.entries.items()], tier.snapshot()]


# --------------------------------------------------------------- hashes
def test_prefix_hashes_equal_jax():
    rng = np.random.default_rng(0)
    for n, block in ((0, 4), (7, 4), (64, 8), (300, 16)):
        toks = rng.integers(0, 50_000, n).astype(np.int32)
        assert prefix_hashes(toks, block) == jax_hashes(toks, block)
        assert token_hash(toks) == jax_hash(toks)
    assert prefix_hashes([5, 6, 7, 8], 2)[-1] == (4, token_hash([5, 6, 7, 8]))


# ----------------------------------------------------- store sequences
def script_host_handshake(pkg, tmp):
    """Put, match, release, consume, a put of a pinned key (skipped), of an
    unpinned one (replaced) and of a page over the whole budget."""
    reg = pkg.registry()
    tier = pkg.host(4096, page_size=4, clock=TickClock(), registry=reg)
    p = np.arange(12, dtype=np.int32)
    log = [tier.put(p[:4], _tiles(1)), tier.put(p[:8], _tiles(2))]
    keys = tier.match(p, start_block=0)      # block 2 absent: the run stops
    log += [keys, _state(tier)]
    tier.release(keys)
    log.append(_state(tier))
    keys = tier.match(p, start_block=1)
    log += [keys, _consumed(tier.consume(keys)), _state(tier)]
    keys = tier.match(p, start_block=0)
    log.append(tier.put(p[:4], _tiles(3)))   # pinned: skipped
    tier.release(keys)
    log.append(tier.put(p[:4], _tiles(4)))   # replaced
    log.append(tier.put(p[:4], _tiles(5, nbytes=8192)))   # over budget
    log += [tier.holds(p[:4]), tier.holds(p[:8]), tier.holds(p[1:5]),
            _state(tier), pkg.crc(_tiles(6)), reg.snapshot()]
    return log


def script_host_lru_pins_owners(pkg, tmp):
    """LRU prunes skip a pinned entry; owner bytes follow every move;
    restore accounting."""
    reg = pkg.registry()
    tier = pkg.host(600, page_size=4, clock=TickClock(), registry=reg)
    p = np.arange(16, dtype=np.int32)
    tier.put(p[:4], _tiles(1), owner="a")
    tier.put(p[:8], _tiles(2), owner="b")
    keys = tier.match(p[:4], start_block=0)      # pin the older entry
    tier.put(p[:12], _tiles(3), owner="a")       # prunes the LRU unpinned
    log = [keys, _state(tier), tier.pressure]
    tier.release(keys)
    tier.put(p[:16], _tiles(4))
    log += [_state(tier), tier.pressure]
    keys = tier.match(p, start_block=0)
    log += [keys, _consumed(tier.consume(keys)) if keys else None]
    tier.on_restore(0.5, pages=len(keys), tokens=4 * len(keys), nbytes=384)
    log += [_state(tier), reg.snapshot()]
    return log


def script_host_collision_and_peek(pkg, tmp):
    tier = pkg.host(4096, page_size=4, clock=TickClock())
    p = np.arange(8, dtype=np.int32)
    tier.put(p[:4], _tiles(1))
    q = p.copy()
    q[3] += 1
    ent = tier.entries[next(iter(tier.entries))]
    ent["tokens"] = tuple(int(t) for t in q[:4])   # a hash collision
    log = [tier.match(p, start_block=0), tier.misses,
           tier.match(p, start_block=1), tier.misses]
    tier2 = pkg.host(4096, page_size=4, clock=TickClock())
    tier2.put(p[:4], _tiles(1))
    tier2.put(p[:8], _tiles(2))
    log += [tier2.peek_blocks(p, 0), tier2.peek_blocks(p, 1),
            tier2.peek_blocks(p[::-1].copy(), 0), _state(tier2)]
    return log


def script_nvme_round_trip(pkg, tmp):
    reg = pkg.registry()
    tier = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock(),
                    registry=reg)
    p = np.arange(12, dtype=np.int32)
    tier.put(p[:4], _tiles(1))
    tier.put(p[:8], _tiles(2))
    tier.flush()
    log = [[tier.store.exists(tier._file(k)) for k in tier.entries],
           _state(tier)]
    keys = tier.match(p, start_block=0)
    log += [keys, _state(tier), _consumed(tier.consume(keys)),
            sorted(os.listdir(tier.store.dir)), _state(tier),
            reg.snapshot()]
    tier.close()
    return log


def script_nvme_release_keeps_file(pkg, tmp):
    tier = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock())
    p = np.arange(4, dtype=np.int32)
    tier.put(p, _tiles(3))
    keys = tier.match(p, start_block=0)
    log = [keys, _state(tier)]
    tier.release(keys)
    log += [_state(tier), tier.store.exists(tier._file(keys[0]))]
    keys = tier.match(p, start_block=0)      # read back from the disk again
    log += [keys, _consumed(tier.consume(keys)), _state(tier)]
    tier.close()
    return log


def script_nvme_torn_corrupt_lost(pkg, tmp):
    tier = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock())
    p = np.arange(12, dtype=np.int32)
    for n in (4, 8, 12):
        tier.put(p[:n], _tiles(n))
    tier.flush()
    keys = sorted(tier.entries)
    f0, f1 = (tier.store.path(tier._file(k)) for k in keys[:2])
    with open(f0, "r+b") as f:               # torn: half the bytes
        f.truncate(os.path.getsize(f0) // 2)
    with open(f1, "r+b") as f:               # bit rot
        f.write(b"\x5a" * 16)
    tier.store.unlink(tier._file(keys[2]))   # lost
    log = [tier.match_one(keys[0], p[:4], 4),
           tier.match_one(keys[1], p[:8], 8),
           tier.match_one(keys[2], p[:12], 12),
           tier.match(p, start_block=0),
           _norm(_state(tier), drop=("aio_errors",))]
    errors = tier.store.errors
    tier.close()
    return log, errors


def script_nvme_lost_write(pkg, tmp):
    tier = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock())
    p = np.arange(4, dtype=np.int32)
    tier.put(p, _tiles(5))
    tier.flush()
    tier.store.unlink(tier._file(next(iter(tier.entries))))
    log = [tier.match(p, start_block=0), _state(tier)]
    tier.close()
    return log


def script_nvme_lost_middle_block(pkg, tmp):
    """A match over three disk blocks whose middle file is gone: the
    first restores, the second falls back, the walk stops (the port has
    read the third with the others, and drops it)."""
    tier = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock())
    p = np.arange(12, dtype=np.int32)
    for n in (4, 8, 12):
        tier.put(p[:n], _tiles(n))
    tier.flush()
    tier.store.unlink(tier._file(sorted(tier.entries)[1]))
    keys = tier.match(p, start_block=0)
    log = [keys, _state(tier), _consumed(tier.consume(keys)), _state(tier)]
    tier.close()
    return log


def script_spill_spans_rungs(pkg, tmp):
    reg = pkg.registry()
    host = pkg.host(600, page_size=4, clock=TickClock(), registry=reg)
    nvme = pkg.nvme(1 << 20, page_size=4, path=str(tmp), clock=TickClock(),
                    registry=reg)
    eng = pkg.engine([host, nvme])
    p = np.arange(16, dtype=np.int32)
    for n, s in ((4, 1), (8, 2), (12, 3)):
        eng.put(p[:n], _tiles(s), owner="t")
    keys = eng.match(p, start_block=0)
    log = [keys, _state(host), _state(nvme), eng.snapshot(),
           eng.holds(p[:4]), eng.holds(p[:12]), eng.peek_blocks(p, 0),
           eng.pressure]
    log += [_consumed(eng.consume(keys)), eng.snapshot(), reg.snapshot()]
    nvme.close()
    return log


def script_spill_chain_caps(pkg, tmp):
    host = pkg.host(600, page_size=4, clock=TickClock())
    nvme = pkg.nvme(600, page_size=4, path=str(tmp), clock=TickClock())
    eng = pkg.engine([host, nvme])
    p = np.arange(32, dtype=np.int32)
    for n in range(4, 33, 4):
        eng.put(p[:n], _tiles(n))
    log = [_state(host), _state(nvme),
           len(os.listdir(nvme.store.dir)) == len(nvme.entries)]
    keys = eng.match(p, start_block=0)
    log += [keys, eng.match(p, start_block=6)]
    eng.release(eng.match(p, start_block=6))
    log += [eng.snapshot()]
    nvme.close()
    return log


SCRIPTS = {f.__name__[len("script_"):]: f for f in (
    script_host_handshake, script_host_lru_pins_owners,
    script_host_collision_and_peek, script_nvme_round_trip,
    script_nvme_release_keeps_file, script_nvme_lost_write,
    script_nvme_lost_middle_block,
    script_spill_spans_rungs, script_spill_chain_caps)}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_store_sequence_equals_jax(name, tmp_path):
    got = SCRIPTS[name](PORT, tmp_path / "port")
    want = SCRIPTS[name](JAX, tmp_path / "jax")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(_norm(got), _norm(want))):
        assert g == w, (name, i)


def test_torn_corrupt_and_lost_files_fall_back_as_jax(tmp_path):
    """Every bad copy is a counted fallback, at match time, in both; the
    aio error counts differ as the module docstring says: the torn read
    and the lost file's open here, the torn read twice there."""
    got, errors = script_nvme_torn_corrupt_lost(PORT, tmp_path / "port")
    want, jax_errors = script_nvme_torn_corrupt_lost(JAX, tmp_path / "jax")
    assert _norm(got) == _norm(want)
    assert got[:3] == ["corrupt"] * 3 and got[3] == []
    assert got[4][1]["fallbacks"] == 3 and not got[4][0]
    assert (errors, jax_errors) == (2, 3)


def test_nvme_keeps_dtypes_and_reports_o_direct(tmp_path):
    """bf16 tiles ride as int16 views (no numpy bf16): the bytes and the
    CRC come back exactly; the snapshot says whether O_DIRECT was asked
    for and granted."""
    tier = NVMeKVTier(1 << 20, page_size=4, path=str(tmp_path),
                      clock=TickClock(), use_direct=True)
    k = torch.randn(2, 3, 4, 8).to(torch.bfloat16)
    tiles = {"k": k.view(torch.int16).numpy(),
             "k_scale": np.linspace(0, 1, 24, dtype=np.float32)}
    p = np.arange(4, dtype=np.int32)
    tier.put(p, tiles)
    keys = tier.match(p, start_block=0)
    got, _, _ = tier.consume(keys)
    assert len(got["k"]) == 1                # the one block, as it was read
    back = torch.from_numpy(got["k"][0].copy()).view(torch.bfloat16)
    assert torch.equal(back, k)
    snap = tier.snapshot()
    assert snap["native_aio"] and snap["fallbacks"] == 0
    od = snap["o_direct"]
    assert od["requested"] and od["opened"] >= 2
    assert 0 <= od["granted"] <= od["opened"]
    tier.close()


def test_nvme_match_submits_its_reads_together(tmp_path):
    """A match over disk-held blocks submits every read before it waits
    on any, and reads no block that the host rung above holds; a gap ends
    the run it reads."""
    host = HostKVTier(1 << 20, page_size=4, clock=TickClock())
    nvme = NVMeKVTier(1 << 20, page_size=4, path=str(tmp_path),
                      clock=TickClock())
    eng = TieringEngine([host, nvme])
    p = np.arange(24, dtype=np.int32)
    for n in (8, 12, 16, 24):                # block 5 (20 tokens) absent
        nvme.put(p[:n], _tiles(n))
    host.put(p[:4], _tiles(4))
    nvme.flush()
    calls = []
    submit, wait = nvme.store.submit_read, nvme.store.wait

    def logged_submit(name, buf, offset=0):
        calls.append(("read", name))
        return submit(name, buf, offset)

    def logged_wait(ticket):
        calls.append(("wait", ticket))
        return wait(ticket)

    nvme.store.submit_read, nvme.store.wait = logged_submit, logged_wait
    keys = eng.match(p, start_block=0)
    assert [k[0] for k in keys] == [0, 1, 1, 1]
    reads = [c for c in calls if c[0] == "read"]
    assert [c[0] for c in calls[:3]] == ["read"] * 3 and len(reads) == 3
    assert {c[1] for c in reads} == {nvme._file(k) for _, k in keys[1:]}
    got, _, tokens = eng.consume(keys)
    assert tokens == 16
    for i, n in enumerate((4, 8, 12, 16)):
        for name, want in _tiles(n).items():
            np.testing.assert_array_equal(got[name][i], want)
    assert nvme.snapshot()["promotions"] == 3
    assert nvme.snapshot()["fallbacks"] == 0
    nvme.close()


# ------------------------------------------------------------------ aio
def test_aio_library_round_trips_and_counts_errors(tmp_path):
    store = aio.AIOFileStore(str(tmp_path), n_threads=2, use_direct=True)
    a = np.random.default_rng(1).integers(0, 255, 3 << 20).astype(np.uint8)
    store.sync_write("a.bin", a)
    b = np.zeros_like(a)
    store.sync_read("a.bin", b)
    np.testing.assert_array_equal(a, b)
    tickets = [store.submit_write(f"p{i}.bin", a[i << 20:(i + 1) << 20])
               for i in range(3)]
    store.wait(tickets[-1])                  # waits every earlier ticket
    c = np.zeros(1 << 20, np.uint8)
    store.sync_read("p1.bin", c)
    np.testing.assert_array_equal(c, a[1 << 20:2 << 20])
    assert store.errors == 0
    with pytest.raises(OSError):             # past the end: a short read
        store.sync_read("p2.bin", np.zeros(2 << 20, np.uint8))
    assert store.errors == 1
    store.sync_read("p1.bin", c)             # the next wait is clean
    assert store.errors == 1
    with pytest.raises(OSError, match="open failed"):
        store.sync_read("missing.bin", c)
    assert store.errors == 2
    od = store.aio.o_direct()
    assert od["requested"] and od["opened"] >= 4
    assert 0 <= od["granted"] <= od["opened"]
    store.unlink("a.bin")
    assert not store.exists("a.bin")
    store.close()
    assert aio.native_available()


def test_aio_has_no_python_fallback(monkeypatch, tmp_path):
    """Without g++ the library cannot build, and every user raises; no
    Python I/O path exists in the module."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(builder, "_loaded", {})
    with pytest.raises(builder.KernelBuildError, match="g.. not found"):
        aio.AsyncIOHandle()
    with pytest.raises(builder.KernelBuildError, match="g.. not found"):
        NVMeKVTier(1 << 20, page_size=4, path=str(tmp_path))
    assert not aio.native_available()
    text = open(aio.__file__).read()
    for word in ("ThreadPoolExecutor", "os.pread", "os.pwrite", "tobytes"):
        assert word not in text


def test_builder_builds_host_code_with_gxx(monkeypatch, tmp_path):
    """g++ with the portable flags (no -march=native), hashed by source
    and flags; concurrent builders of one library both succeed."""
    assert builder.host_sources() == ["aio"]
    assert "aio" not in builder.sources()
    assert "-march=native" not in builder.GXX_FLAGS
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(builder, "_loaded", {})
    path = builder.library_path("aio")
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("libaio-")
    out, errs = {}, []

    def build(i):
        try:
            out[i] = builder.build_all(["aio"])["aio"]
        except Exception as e:      # reported below
            errs.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    info = out[0]
    assert info["path"] == str(path) and path.exists()
    assert info["command"].split()[0].endswith("g++")
    assert " ".join(builder.GXX_FLAGS) in info["command"]
    assert [p.suffix for p in sorted((tmp_path / "build").iterdir())] == \
        [".log", ".so"]
    assert hasattr(builder.load("aio"), "ds_aio_submit_read")


def test_builder_reports_gxx_output_on_failure(monkeypatch, tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: fake g++ says no' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(builder.KernelBuildError, match="fake g.. says no"):
        builder.build_all(["aio"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_pinned_pages_recycle_their_slots():
    """A slot returns to the free list once the last numpy view or tensor
    over it is gone, not before; an empty list grows by a slab; a request
    past the slot size raises."""
    import gc

    pages = PinnedPages(256, slots=2, pin=False)
    a, b = pages.take(), pages.take(100, zero=True)
    assert (a.nbytes, b.nbytes, pages.free) == (256, 100, [])
    assert not b.any()
    view = torch.from_numpy(a[64:128].view(np.int16)).view(torch.bfloat16)
    del a
    gc.collect()
    assert pages.free == []                  # the tensor still views it
    view.fill_(1.0)
    del view
    gc.collect()
    assert len(pages.free) == 1
    c, d = pages.take(), pages.take()        # the freed slot, then a slab
    assert pages.slots == 2 + PinnedPages.PER_SLAB
    assert len(pages.free) == PinnedPages.PER_SLAB - 1
    assert c.ctypes.data != d.ctypes.data != b.ctypes.data
    with pytest.raises(ValueError, match="page slot"):
        pages.take(257)


# ---------------------------------------------------------------- pool
def _alloc_view(a):
    if a is None:
        return None
    tiles = a.restore_tiles and _consumed((a.restore_tiles, 0, 0))[0]
    return (a.rid, a.row.tolist(), a.pages, a.shared, a.skip,
            a.hydrate_row.tolist(), a.hydrate_pages, a.cow, a.cow_src,
            a.restored, a.restore_tokens, a.restore_bytes, _norm(tiles))


def _pool_tier_script(pkg):
    """A pool of 8 usable pages with a host tier and a stepped clock: the
    demote handler puts each evicted block into the tier at once, with
    tiles made from its page; admissions evict, restore, defer with pins
    and copy on write; demote-ahead candidates at two cutoffs."""
    clock = TickClock(dt=0.5)
    reg = pkg.registry()
    pool = pkg.pool(pages=9, page_size=4, max_len=32, registry=reg,
                    clock=clock)
    host = pkg.host(1 << 20, page_size=4, registry=reg, clock=clock)
    pool.host = host
    log = []

    def on_demote(entries):
        log.append(("demote", [(e["tokens"], e["page"], e["block"])
                               for e in entries]))
        for e in entries:
            host.put(e["tokens"], {
                "k": np.full((2, 4), e["page"], np.float32),
                "v": np.arange(8, dtype=np.int8) + e["page"]})

    pool.on_demote = on_demote
    rng = np.random.default_rng(5)
    a = rng.integers(0, 90, 16).astype(np.int32)
    b = rng.integers(0, 90, 16).astype(np.int32)
    prompts = {1: a, 2: b, 3: a.copy(), 4: np.concatenate([a, [1, 2]]),
               5: b.copy(), 6: a[:10].copy(), 7: b.copy()}
    news = {1: 4, 2: 4, 3: 4, 4: 3, 5: 4, 6: 4, 7: 4}
    script = [("admit", 1), ("insert", 1), ("release", 1),
              ("admit", 2), ("insert", 2), ("release", 2),
              ("admit", 3), ("insert", 3),       # restores a's demoted blocks
              ("admit", 4),                      # defers: pins released
              ("candidates", 0.0), ("release", 3),
              ("admit", 4), ("insert", 4), ("release", 4),
              ("candidates", 1e9), ("admit", 5), ("insert", 5),
              ("admit", 6), ("release", 5), ("admit", 6), ("insert", 6),
              ("release", 6), ("admit", 7), ("insert", 7), ("release", 7)]
    for op in script:
        if op[0] == "admit":
            log.append(("admit", _alloc_view(
                pool.try_admit(prompts[op[1]], news[op[1]], rid=op[1]))))
            log.append(("pins", [(k, e["pinned"])
                                 for k, e in host.entries.items()]))
        elif op[0] == "insert":
            pool.on_inserted(op[1], prompts[op[1]])
        elif op[0] == "release":
            pool.release(op[1])
        else:
            log.append(("candidates", pool.demote_ahead_candidates(
                op[1], 3, skip=host.holds)))
        log.append((op, sorted(pool.free), pool.slot_refs.tolist(),
                    pool.tree_refs.tolist(), pool.generation,
                    pool.snapshot()))
    return log, reg.snapshot()


def test_pool_tier_sequence_equals_jax():
    got = _pool_tier_script(PORT)
    want = _pool_tier_script(JAX)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(_norm(got[0]), _norm(want[0]))):
        assert g == w, i
    assert _norm(got[1]) == _norm(want[1])
    admits = [e[1] for e in got[0] if e[0] == "admit"]
    assert any(a is not None and a[9] > 0 for a in admits)      # restored
    assert any(a is None for a in admits)                       # deferred
    snap = got[0][-1][-1]
    assert snap["host_tier"]["restores"] == 0        # the engine counts them
    assert snap["oldest_tree_entry_age_s"] is not None


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    """(JAX InferenceEngine, port InferenceEngine) on one init of
    ``tiny_test``, fp32, eos 7."""
    jm, jparams, tm, tparams = make_pair("tiny_test")
    conf = {"dtype": "float32", "eos_token_id": EOS}
    return (jds.init_inference(jm, jparams, conf),
            dt.init_inference(tm, tparams, conf, device="cpu"))


def _scfg(host=HOST, pool_pages=POOL, **extra):
    cfg = {"slots": 2, "max_len": M, "prefill_chunk": 16, "greedy": True,
           "page_size": PS, "pool_pages": pool_pages, **extra}
    if host:
        cfg["host_pool_bytes"] = host
    return cfg


def _prompts(n=2, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (P,)).astype(np.int32) for _ in range(n)]


def _run_one(srv, prompt, seed, max_new=MAX_NEW):
    rid = srv.submit(prompt, max_new, seed=seed)
    for _ in range(200_000):
        req = srv.pop_result(rid)
        if req is not None:
            return list(req.tokens)
        srv.step()
    raise RuntimeError("serving wedged")


def _cycle(srv, rounds=3, max_new=MAX_NEW):
    """Two sessions alternating on a one-request pool: every resume finds
    its prefix evicted (demoted, with a tier)."""
    A, B = _prompts()
    toks = []
    for r in range(rounds):
        toks.append(_run_one(srv, A, 1000 + r, max_new))
        toks.append(_run_one(srv, B, 2000 + r, max_new))
    return toks


COUNTERS = ("pages", "bytes", "demotes", "demote_bytes", "demote_skips",
            "restores", "restored_pages", "restored_tokens", "restore_bytes",
            "hits", "misses", "prunes", "pruned_bytes", "spills",
            "fallbacks", "promotions", "read_bytes", "write_bytes")


def _counters(snap) -> dict:
    out = {k: snap[k] for k in COUNTERS if k in snap}
    if "nvme_tier" in snap:
        out["nvme_tier"] = _counters(snap["nvme_tier"])
    return out


def _entries_match(port_tier, jax_tier):
    assert list(port_tier.entries) == list(jax_tier.entries)
    for k, e in port_tier.entries.items():
        w = jax_tier.entries[k]
        assert e["tokens"] == w["tokens"]
        for name, want in w["tiles"].items():
            got = e["tiles"][name]
            assert got.shape == want.shape and got.dtype == want.dtype
            top = np.abs(want).max()
            assert np.abs(got - want).max() <= TILE_SHARE * top, (k, name)


TIER_CASES = {
    "host": {},
    "nvme": {"host": 3 * PAGE_NBYTES, "nvme_pool_bytes": 64 << 20},
}


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_tier_tokens_and_counters_equal_jax(engines, case, tmp_path):
    je, te = engines
    extra = dict(TIER_CASES[case])
    if case == "nvme":
        extra["nvme_path"] = str(tmp_path)
    jsrv = jds.serving.ServingEngine(je, _scfg(**extra))
    srv = ServingEngine(te, _scfg(**extra))
    want = _cycle(jsrv)
    got = _cycle(srv)
    off = _cycle(ServingEngine(te, _scfg(host=0)))
    assert got == want and got == off
    A, _B = _prompts()
    solo = te.generate(A[None], MAX_NEW, greedy=True, request_seeds=[1002],
                       cache_len=M)[0].tolist()
    assert solo[:len(got[4])] == got[4]           # round 3's A: restored
    snap = srv.tier_snapshot()
    assert _counters(snap) == _counters(jsrv.pool.snapshot()["host_tier"])
    assert snap["restores"] >= 4 and snap["fallbacks"] == 0
    _entries_match(srv.hostkv, jsrv.hostkv)
    if case == "nvme":
        assert snap["spills"] > 0 and snap["nvme_tier"]["promotions"] > 0
        srv.nvmekv.flush()
        jsrv.nvmekv.flush()
        assert list(srv.nvmekv.entries) == list(jsrv.nvmekv.entries)
        srv.close()
    assert srv.captures == 0


def test_int8_tier_tokens_equal_jax(engines):
    je, te = engines
    cfg = _scfg(kv_quant_bits=8)
    want = _cycle(jds.serving.ServingEngine(je, cfg), max_new=6)
    srv = ServingEngine(te, cfg)
    assert _cycle(srv, max_new=6) == want
    hs = srv.tier_snapshot()
    assert hs["restores"] >= 4 and hs["fallbacks"] == 0
    ent = next(iter(srv.hostkv.entries.values()))
    assert sorted(ent["tiles"]) == ["k", "k_scale", "v", "v_scale"]
    assert ent["tiles"]["k"].dtype == np.int8


def test_restored_block_equals_its_pool_page_before_eviction(engines):
    """The pool pages a demotion gathers, cloned at the eviction, equal
    the restored pages of the prefill cache a later admission uploads."""
    _je, te = engines
    srv = ServingEngine(te, _scfg())
    before, seen = {}, []
    demote, restore = srv._demote_pages, srv._restore_dispatch

    def on_demote(entries):
        c = srv.state.cache
        for e in entries:
            before[tuple(e["tokens"])] = (c.k[:, e["page"]].clone(),
                                          c.v[:, e["page"]].clone())
        demote(entries)

    def on_restore(cache, alloc):
        prompt = srv._prefill_prompt
        restore(cache, alloc)
        n = cache.k.shape[3] // PS
        for b in range(alloc.shared, alloc.shared + alloc.restored):
            k, v = before[tuple(int(t) for t in prompt[:(b + 1) * PS])]
            assert torch.equal(_page_split(cache.k, n, PS)[:, b], k)
            assert torch.equal(_page_split(cache.v, n, PS)[:, b], v)
            seen.append(b)

    srv.pool.on_demote = on_demote
    srv._restore_dispatch = on_restore
    pop = srv.sched.pop_next

    def pop_next():
        req = pop()
        if req is not None:
            srv._prefill_prompt = req.prompt
        return req

    srv.sched.pop_next = pop_next
    _cycle(srv, rounds=2)
    assert len(seen) >= 4


# --------------------------------------------------------- demote-ahead
IDLE = 10.0


def _da(engine, make, idle_s=IDLE, dt=0.001):
    clock = TickClock(dt=dt)
    srv = make(engine, _scfg(demote_ahead_idle_s=idle_s), clock=clock)
    return srv, clock


def _registry_counters(srv):
    return srv.stats.registry.snapshot()["counters"]


def test_demote_ahead_stages_and_fast_frees_as_jax(engines):
    """``tests/unit/test_demote_ahead.py``'s threshold, staging and
    fast-free sequence on both engines: nothing stages under the idle
    threshold; past it the whole idle chain stages (a copy: the pages stay
    tree-held, and a second tick stages nothing more); B's admission then
    evicts A's staged pages with no copy, the demote wait stays 0.0, and
    A's resume restores."""
    je, te = engines
    logs = []
    for eng, make in ((je, jds.serving.ServingEngine), (te, ServingEngine)):
        srv, clock = _da(eng, make)
        A, B = _prompts()
        log = [_run_one(srv, A, 1)]
        held = srv.pool.tree_held
        srv.step()
        log += [held, len(srv.hostkv.entries)]
        clock.advance(IDLE + 1.0)
        srv.step()
        log += [_registry_counters(srv).get("Serve/demote_ahead_staged"),
                sorted(srv._staged_ahead), list(srv.hostkv.entries),
                srv.pool.tree_held]
        clock.advance(IDLE + 1.0)
        srv.step()
        log.append(_registry_counters(srv)["Serve/demote_ahead_staged"])
        log.append(_run_one(srv, B, 2))
        c = _registry_counters(srv)
        log += [c["Serve/demote_ahead_fastfrees"], srv.demote_wait_s,
                sorted(srv._staged_ahead)]
        log.append(_run_one(srv, A, 3))
        log.append(_counters(srv.pool.snapshot()["host_tier"]))
        logs.append(log)
    got, want = logs
    assert got == want
    assert got[2] == 0 and got[3] == got[1] and got[6] == got[1]
    assert got[7] == got[1] and got[9] >= got[1] - 1 and got[10] == 0.0
    assert got[13]["restores"] > 0


def test_demote_ahead_churn_equals_jax_and_leaks_nothing(engines):
    """12 sessions, every gap past the threshold: the staged sets, the
    counters and the tier's entries equal JAX's, and nothing leaks."""
    je, te = engines
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (P,)).astype(np.int32)
               for _ in range(12)]
    out = []
    for eng, make in ((je, jds.serving.ServingEngine), (te, ServingEngine)):
        srv, _clock = _da(eng, make, idle_s=0.1, dt=0.5)
        toks = [_run_one(srv, p, 9000 + 31 * s + r)
                for r in range(2) for s, p in enumerate(prompts)]
        srv.drain()
        c = _registry_counters(srv)
        out.append((srv, [toks, c["Serve/demote_ahead_staged"],
                          c["Serve/demote_ahead_fastfrees"],
                          sorted(srv._staged_ahead), list(srv.hostkv.entries),
                          srv.demote_wait_s,
                          _counters(srv.pool.snapshot()["host_tier"])]))
    (jsrv, want), (srv, got) = out
    assert got == want
    assert got[2] > 0 and got[5] == 0.0
    pool, tier = srv.pool, srv.hostkv
    assert not pool._alloc and np.all(pool.slot_refs == 0)
    assert len(pool.free) + pool.tree_held == pool.usable
    assert tier.bytes_used == sum(e["nbytes"] for e in tier.entries.values())
    assert srv._staged_ahead <= set(tier.entries)
    assert all(not e["pinned"] for e in tier.entries.values())


# ---------------------------------------------------------- degradation
def test_corrupt_host_copy_falls_back_to_recompute(engines):
    _je, te = engines
    srv = ServingEngine(te, _scfg())
    ref = ServingEngine(te, _scfg(host=0))
    A, B = _prompts()
    for s, prompt in enumerate((A, B)):
        _run_one(srv, prompt, 1000 + s)
        _run_one(ref, prompt, 1000 + s)
    # A's 4 blocks are in the tier: corrupt its first, so the whole run
    # breaks at the gap and recomputes
    key = min(srv.hostkv.entries, key=lambda k: k[0])
    srv.hostkv.entries[key]["tiles"]["k"].flat[0] += 1
    assert _run_one(srv, A, 2000) == _run_one(ref, A, 2000)
    hs = srv.tier_snapshot()
    assert hs["fallbacks"] == 1 and hs["restores"] == 0
    assert _registry_counters(srv)["Serve/host_tier_fallbacks"] == 1
    assert key not in srv.hostkv.entries


def test_tier_too_small_for_a_page_recomputes(engines):
    _je, te = engines
    srv = ServingEngine(te, _scfg(host=64))
    assert _cycle(srv, rounds=2) == _cycle(ServingEngine(te, _scfg(host=0)),
                                           rounds=2)
    hs = srv.tier_snapshot()
    assert hs["pages"] == 0 and hs["restores"] == 0 and hs["demote_skips"] > 0


def test_oversubscription_churn_leaks_nothing(engines):
    """10 sessions' worst-case pages against a pool that holds one, three
    rounds on a stepped clock: no live allocation after the drain, every
    page free or tree-held, the tier's bytes the sum of its entries and
    within its budget, nothing pinned."""
    _je, te = engines
    srv = ServingEngine(te, _scfg(), clock=TickClock(dt=0.25))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (P,)).astype(np.int32)
               for _ in range(10)]
    for r in range(3):
        for s, p in enumerate(prompts):
            _run_one(srv, p, 9000 + 31 * s + r)
    srv.drain()
    pool, tier = srv.pool, srv.hostkv
    assert not pool._alloc and np.all(pool.slot_refs == 0)
    assert len(pool.free) + pool.tree_held == pool.usable
    assert tier.bytes_used == sum(e["nbytes"] for e in tier.entries.values())
    assert tier.bytes_used <= tier.capacity_bytes
    assert all(not e["pinned"] for e in tier.entries.values())
    hs = srv.tier_snapshot()
    assert hs["restores"] > 0 and hs["fallbacks"] == 0
    assert not srv._pending_demotes and not srv._restores_in_flight
    # each entry holds one page slot; every other slot is free again
    import gc

    gc.collect()
    pages = srv._pages
    assert pages.slots - len(pages.free) == len(tier.entries)
    assert pages.slots == HOST // PAGE_NBYTES + srv.pool.pages_per_slot


# ------------------------------------------------------ off by default
def test_tier_off_builds_nothing(engines):
    _je, te = engines
    srv = ServingEngine(te, _scfg(host=0))
    _cycle(srv, rounds=1)
    assert srv.hostkv is None and srv.nvmekv is None
    assert srv.pool.host is None and srv.pool.on_demote is None
    assert srv.pool.clock is None and srv.tier_snapshot() is None
    snap = srv.metrics_snapshot()
    assert "tiers" not in snap and snap["pages"]["host_tier"] is None
    assert not any(k.startswith("Serve/host_tier")
                   for k in srv.stats.registry.snapshot()["gauges"])
    with pytest.raises(NotImplementedError, match=r"part 6\(c\)"):
        srv.prefix_residency(np.arange(8))
    with pytest.raises(NotImplementedError, match=r"part 6\(c\)"):
        srv.export_slot(0)


BASE = {"page_size": 8, "max_len": 64, "prefill_chunk": 16}


@pytest.mark.parametrize("cfg,match", [
    ({"prefill_chunk": 16, "max_len": 64, "host_pool_bytes": 1 << 20},
     "host_pool_bytes"),
    ({**BASE, "host_pool_bytes": -1}, "host_pool_bytes"),
    ({**BASE, "nvme_pool_bytes": 1 << 20}, "nvme_pool_bytes"),
    ({**BASE, "host_pool_bytes": 1 << 20, "nvme_pool_bytes": -1},
     "nvme_pool_bytes"),
    ({**BASE, "demote_ahead_idle_s": 5.0}, "demote_ahead_idle_s"),
    ({**BASE, "host_pool_bytes": 1 << 20, "demote_ahead_idle_s": -1.0},
     "demote_ahead_idle_s"),
])
def test_tier_config_validation_as_jax(cfg, match):
    from deepspeed_tpu.inference.config import \
        ServingConfig as JaxServingConfig

    with pytest.raises(ValueError, match=match):
        JaxServingConfig.from_any(cfg)
    with pytest.raises(ValueError, match=match):
        ServingConfig.from_any(cfg)


def test_tier_config_accepts_the_jax_keys(tmp_path):
    cfg = ServingConfig.from_any({
        **BASE, "host_pool_bytes": 1 << 20, "nvme_pool_bytes": 1 << 24,
        "nvme_path": str(tmp_path), "demote_ahead_idle_s": 5.0})
    assert (cfg.host_pool_bytes, cfg.nvme_pool_bytes, cfg.nvme_path,
            cfg.demote_ahead_idle_s) == (1 << 20, 1 << 24, str(tmp_path),
                                         5.0)
    with pytest.raises(NotImplementedError, match=r"part 6\(c\)"):
        ServingConfig.from_any({**BASE, "autoscale": {"enabled": True}})
