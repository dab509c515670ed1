"""deepspeed_tpu_torch checkpoints and crash-safe resume, on the CPU.

- Resume parity: k steps, save, a fresh engine (another seed) loads, m more
  steps; everything equals k + m unbroken steps BIT FOR BIT (losses, grad
  norms, lr, master, mu, nu, count, step, loss scale, skipped steps). Both
  runs execute the same ops on the same values in the same order, so any
  difference is a state the checkpoint lost.
- The async writer racing the steps that follow its save.
- The commit protocol on the engine (JAX
  ``test_save_load_verified_fallback_and_prune``) and the integrity
  functions against the JAX package's on the same directories.
- The crash → preempt → verify chain, each phase a subprocess (JAX
  ``test_crash_mid_commit_then_preempt_then_resume``, without the flight
  record).
- A JAX ``TrainState`` carried into the port and trained on: losses and
  masters within ``tests/test_torch_train.py``'s fp32 tolerance (1e-5;
  ``layers.bk`` left out, as there).
- Both converters, read back by the other side.
- The non-finite sentinel and ``resume: "auto"``.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu.resilience import integrity as jax_integrity
from deepspeed_tpu.runtime.checkpoint import to_fp32 as jax_to_fp32
from deepspeed_tpu_torch.models import (params_from_jax, params_to_numpy,
                                        read_fp32_safetensors,
                                        train_state_from_jax)
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.resilience import CheckpointIntegrityError
from deepspeed_tpu_torch.resilience import integrity as port_integrity
from deepspeed_tpu_torch.runtime.checkpoint import engine as ckpt
from deepspeed_tpu_torch.runtime.checkpoint import to_fp32 as port_to_fp32
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 32
STEPS = 4
TOL = 1e-5          # tests/test_torch_train.py, fp32


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0))


def batches(n=STEPS, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (8, S)).astype(np.int32)}
            for _ in range(n)]


def config(dtype="float32", **over):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"warmup_num_steps": 2,
                                    "total_num_steps": 10}},
           "gradient_clipping": 1.0,
           "remat": {"enabled": True, "policy": "dots_saveable"},
           "bf16": {"enabled": dtype == "bfloat16"},
           "fp16": {"enabled": dtype == "float16"},
           "steps_per_print": 1000}
    cfg.update(over)
    return cfg


def port_engine(conf, seed, dtype=torch.float32):
    cfg = torch_presets.tiny_test(dtype=dtype, max_seq=64)
    return dt.initialize(conf, dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()), seed=seed,
        device="cpu")


def step_record(m) -> tuple:
    return (float(m["loss"]), float(m["grad_norm"]), m["lr"],
            m["loss_scale"], m["skipped"])


def assert_same_state(a, b):
    assert (a.step, a.global_steps, a.skipped_steps, a.opt_state.count,
            a.loss_scale) == (b.step, b.global_steps, b.skipped_steps,
                              b.opt_state.count, b.loss_scale)
    for group in ("master", "mu", "nu"):
        ga, gb = ckpt._groups(a)[group], ckpt._groups(b)[group]
        assert set(ga) == set(gb)
        for k in ga:
            assert torch.equal(ga[k], gb[k]), (group, k)


def state_copy(engine) -> dict:
    return {g: {k: t.clone() for k, t in d.items()}
            for g, d in ckpt._groups(engine).items()}


# ------------------------------------------------------------ resume parity
# name: (compute dtype, extra config); fp16 starts at 2**21, where the
# first step overflows (skipped before the save), the window of 2 doubles
# the scale at step 3 and step 4 overflows again
PARITY = {
    "fp32_sync": ("float32", {}),
    "fp32_async": ("float32", {"checkpoint": {"async_save": True}}),
    "bf16_sync": ("bfloat16", {}),
    "bf16_async": ("bfloat16", {"checkpoint": {"async_save": True}}),
    "fp16_skip_sync": ("float16", {"fp16": {
        "enabled": True, "initial_scale_power": 21, "hysteresis": 1,
        "loss_scale_window": 2}}),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_resume_equals_unbroken_run_bit_for_bit(tmp_path, name):
    dtype, over = PARITY[name]
    tdt = getattr(torch, dtype)
    conf = config(dtype, **over)
    data, k = batches(), 2
    whole = port_engine(conf, seed=1, dtype=tdt)
    want = [step_record(whole.train_batch(dict(b))) for b in data]
    first = port_engine(conf, seed=1, dtype=tdt)
    got = [step_record(first.train_batch(dict(b))) for b in data[:k]]
    first.save_checkpoint(tmp_path)
    first.wait_for_checkpoint()
    if name.startswith("fp16"):
        assert first.skipped_steps >= 1          # a skip before the save
    resumed = port_engine(conf, seed=2, dtype=tdt)
    assert resumed.load_checkpoint(tmp_path).endswith(f"global_step{k}")
    got += [step_record(resumed.train_batch(dict(b))) for b in data[k:]]
    assert got == want
    assert_same_state(resumed, whole)
    if name.startswith("fp16"):
        assert [r[4] for r in want] == [1, 0, 0, 1]


def test_async_write_races_the_following_steps(tmp_path, monkeypatch):
    """The writer is held until two more steps have updated the state in
    place; the tag still holds the state at the save."""
    gate, started = threading.Event(), threading.Event()
    real = ckpt.write_file

    def slow_write(*a, **kw):
        started.set()
        assert gate.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "write_file", slow_write)
    conf = config(checkpoint={"async_save": True})
    eng = port_engine(conf, seed=1)
    data = batches()
    for b in data[:2]:
        eng.train_batch(dict(b))
    saved = state_copy(eng)
    eng.save_checkpoint(tmp_path)
    assert started.wait(timeout=60)
    for b in data[2:]:
        eng.train_batch(dict(b))
    assert eng._pending_save.thread.is_alive()       # the writer still waits
    assert not (tmp_path / "latest").exists()         # nothing committed yet
    gate.set()
    eng.wait_for_checkpoint()
    assert (tmp_path / "latest").read_text() == "global_step2"
    assert json.loads((tmp_path / "global_step2" / "manifest.json")
                      .read_text())["global_steps"] == 2
    back = port_engine(conf, seed=9)
    back.load_checkpoint(tmp_path)
    for g, d in ckpt._groups(back).items():
        for k, t in d.items():
            assert torch.equal(t, saved[g][k]), (g, k)
    assert back.global_steps == 2 and back.opt_state.count == 2


@pytest.mark.parametrize("async_save", [False, True])
def test_write_error_propagates_and_commits_nothing(tmp_path, monkeypatch,
                                                    async_save):
    eng = port_engine(config(checkpoint={"async_save": async_save}), seed=1)
    eng.save_checkpoint(tmp_path)
    eng.wait_for_checkpoint()

    def broken(*a, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt, "write_file", broken)
    eng.global_steps = 5
    with pytest.raises((OSError, RuntimeError), match="No space left"):
        eng.save_checkpoint(tmp_path)
        eng.wait_for_checkpoint()
    assert (tmp_path / "latest").read_text() == "global_step0"
    assert not (tmp_path / "global_step5" / "manifest.json").exists()
    assert eng._pending_save is None


# ------------------------------------------- commit protocol on the engine
def test_save_load_verified_fallback_and_prune(tmp_path):
    """keep_last 2 keeps two tags, both verifying at "checksum" in either
    package; a truncated file in the tag ``latest`` names falls back to the
    previous tag; that tag pinned raises."""
    eng = port_engine(config(checkpoint={"verify": "checksum",
                                         "keep_last": 2}), seed=3)
    for step in (1, 2, 3):
        eng.global_steps = step
        eng.save_checkpoint(tmp_path)
    tags = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert tags == ["global_step2", "global_step3"]
    for t in tags:
        for integrity in (port_integrity, jax_integrity):
            for level in ("size", "checksum"):
                assert integrity.verify_tag(tmp_path / t, level)[0] \
                    == "verified"
    victim = tmp_path / "global_step3" / "state" / "nu.safetensors"
    victim.write_bytes(victim.read_bytes()[:-4])
    eng.load_checkpoint(tmp_path)                     # falls back, loudly
    assert eng.global_steps == 2
    with pytest.raises(CheckpointIntegrityError) as ei:
        eng.load_checkpoint(tmp_path, tag="global_step3")
    assert ei.value.tag == "global_step3" and ei.value.reason


# --------------------------------- the integrity functions against JAX's
def _fake_tag(base, name, step, payload=b"0123456789abcdef"):
    tag = base / name
    (tag / "state").mkdir(parents=True)
    (tag / "state" / "leaf0").write_bytes(payload)
    (tag / "state" / "leaf1").write_bytes(payload * 2)
    (tag / "meta.json").write_text(json.dumps({"global_steps": step}))
    return tag


def _roundtrip_case(m, base):
    """JAX ``test_manifest_roundtrip_and_verification``'s sequence."""
    out = []
    tag = _fake_tag(base, "global_step3", 3)
    out.append(m.verify_tag(tag, "size"))
    mf = m.write_manifest(tag, "checksum")
    out.append(sorted(mf["files"]))
    out.append(m.verify_tag(tag, "checksum"))
    (tag / "state" / "leaf1").write_bytes(b"short")
    out.append(m.verify_tag(tag, "size"))
    (tag / "state" / "leaf0").write_bytes(b"X123456789abcdef")
    out.append(m.verify_tag(tag, "size"))
    (tag / "state" / "leaf1").write_bytes(b"0123456789abcdef" * 2)
    out.append(m.verify_tag(tag, "size"))
    out.append(m.verify_tag(tag, "checksum"))
    (tag / "state" / "leaf0").unlink()
    out.append(m.verify_tag(tag, "size"))
    out.append(m.verify_tag(tag, "off"))
    return out


def _fallback_case(m, base):
    """JAX ``test_newest_verified_fallback_and_prune``'s sequence."""
    out = []
    for i in (1, 2, 3, 4):
        m.write_manifest(_fake_tag(base, f"global_step{i}", i), "size")
    (base / "global_step4" / "state" / "leaf0").write_bytes(b"xx")
    out.append(m.newest_verified_tag(base, "size"))
    out.append(m.newest_verified_tag(base, "size", exclude={"global_step3"}))
    _fake_tag(base, "global_step9", 9)
    out.append(m.newest_verified_tag(base, "size"))
    out.append(m.newest_verified_tag(base, "size", accept_legacy=True))
    out.append([d.name for d in m.list_tags(base)])
    shutil.rmtree(base / "global_step9")
    out.append(m.prune_tags(base, keep_last=2, protect={"global_step1"}))
    out.append(sorted(d.name for d in base.iterdir() if d.is_dir()))
    out.append(m.prune_tags(base, keep_last=0))
    return out


@pytest.mark.parametrize("case", [_roundtrip_case, _fallback_case],
                         ids=["manifest_roundtrip", "fallback_and_prune"])
def test_integrity_functions_match_jax(tmp_path, case):
    got = {}
    for name, m in (("jax", jax_integrity), ("port", port_integrity)):
        (tmp_path / name).mkdir()
        got[name] = case(m, tmp_path / name)
    assert got["port"] == got["jax"]
    # and each package's manifests verify under the other's function
    for name, other in (("jax", port_integrity), ("port", jax_integrity)):
        for tag in (tmp_path / name).iterdir():
            if (tag / "manifest.json").exists():
                assert other.verify_tag(tag, "size") \
                    == (port_integrity if other is jax_integrity
                        else jax_integrity).verify_tag(tag, "size")


# ------------------------------------ crash -> preempt -> verify (e2e)
_CHAIN = """
import os, sys
import torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import tiny_test

phase, ckpt = sys.argv[1], sys.argv[2]
engine = dt.initialize({
    "train_batch_size": 8,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
    "checkpoint": {"verify": "checksum", "async_save": phase == "preempt"},
    "resilience": {"resume": "auto", "resume_dir": ckpt},
    "seed": 3,
}, dt.build_model(tiny_test(dtype=torch.float32)), device="cpu")
print(f"PHASE={phase} resumed_step={engine.global_steps}", flush=True)
if phase == "crash":
    engine.global_steps = 1
    engine.save_checkpoint(ckpt)        # commits: manifest + latest
    engine.global_steps = 2
    os.environ["DSTPU_CHAOS_KILL"] = "ckpt:after-state-write"
    engine.save_checkpoint(ckpt)        # dies between state write and flip
    print("UNREACHABLE", flush=True)
elif phase == "preempt":
    assert engine.global_steps == 1, engine.global_steps
    guard = dt.PreemptionGuard(engine).install()
    engine.global_steps = 5
    engine.save_checkpoint(ckpt)        # async: the write in flight
    from deepspeed_tpu_torch.resilience import chaos
    chaos.deliver_preemption()          # SIGTERM -> guard commits, exits 143
    print("UNREACHABLE", flush=True)
elif phase == "verify":
    assert engine.global_steps == 5, engine.global_steps
    print("VERIFY_OK", flush=True)
"""


def test_crash_mid_commit_then_preempt_then_resume(tmp_path):
    """Each phase its own process of the port: (1) crash: step 1 commits,
    step 2 dies after its state write (rc 137, no manifest, ``latest`` at
    step 1); (2) preempt: auto-resume lands on step 1, an async save of
    step 5 is in flight at SIGTERM, the guard commits it and exits 143;
    (3) verify: auto-resume lands on step 5."""
    script = tmp_path / "chain.py"
    script.write_text(_CHAIN)
    base = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=ROOT, DSTPU_LOG_LEVEL="WARNING")
    env.pop("DSTPU_CHAOS_KILL", None)
    env.pop("DSTPU_CHAOS_PREEMPT", None)

    def run(phase):
        return subprocess.run([sys.executable, str(script), phase, str(base)],
                              env=env, capture_output=True, text=True,
                              timeout=120)

    p = run("crash")
    assert p.returncode == 137, (p.stdout[-2000:], p.stderr[-2000:])
    assert "kill_point 'ckpt:after-state-write'" in p.stderr, p.stderr
    assert "UNREACHABLE" not in p.stdout
    assert (base / "latest").read_text().strip() == "global_step1"
    assert (base / "global_step2" / "state" / "master.safetensors").exists()
    for integrity in (port_integrity, jax_integrity):
        assert integrity.verify_tag(base / "global_step2",
                                    "checksum")[0] == "legacy"
    p = run("preempt")
    assert p.returncode == 143, (p.stdout[-2000:], p.stderr[-2000:])
    assert "PHASE=preempt resumed_step=1" in p.stdout, p.stdout
    assert "delivering simulated SIGTERM" in p.stderr
    assert "UNREACHABLE" not in p.stdout
    assert (base / "latest").read_text().strip() == "global_step5"
    for integrity in (port_integrity, jax_integrity):
        assert integrity.verify_tag(base / "global_step5",
                                    "checksum")[0] == "verified"
    p = run("verify")
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    assert "VERIFY_OK" in p.stdout


def test_chaos_preempt_env_fires_at_its_step(tmp_path, monkeypatch):
    """``DSTPU_CHAOS_PREEMPT=N`` raises SIGTERM entering step N: the guard
    (not exiting) sees it there and the step still runs."""
    monkeypatch.setenv("DSTPU_CHAOS_PREEMPT", "1")
    eng = port_engine(config(), seed=1)
    guard = dt.PreemptionGuard(eng, exit_on_signal=False,
                               save_dir=str(tmp_path),
                               save_on_preempt=True).install()
    try:
        data = batches(2)
        eng.train_batch(dict(data[0]))
        assert not guard.preempted
        eng.train_batch(dict(data[1]))
        assert guard.preempted and eng.global_steps == 2
    finally:
        guard.uninstall()
    assert (tmp_path / "latest").read_text() == "global_step1"
    with pytest.raises(ValueError, match="save_dir"):
        dt.PreemptionGuard(eng, save_on_preempt=True)


# ------------------------------------------- the JAX state carried across
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """ONE tiny JAX engine (one device, fp32) trained 2 steps and saved;
    its TrainState restored by orbax, and its fp32 master at the save."""
    import orbax.checkpoint as ocp

    base = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = jax_presets.tiny_test(dtype=jnp.float32, max_seq=64)
    mesh = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jeng = ds.initialize(config(mesh={"data": 1}), jax_build(jcfg),
                         mesh=mesh, seed=0)
    data = batches(4, seed=7)
    for b in data[:2]:
        jeng.train_batch(dict(b))
    path = jeng.save_checkpoint(str(base))
    state = ocp.PyTreeCheckpointer().restore(os.path.join(path, "state"))
    state = jax.tree.map(np.asarray, state)
    return dict(engine=jeng, base=base, path=path, state=state, data=data,
                master=jax.tree.map(np.asarray, jeng.fp32_params()),
                live=jax.tree.map(np.asarray, jeng.state))


def test_jax_state_continues_in_the_port(jax_run):
    r = jax_run
    teng = port_engine(config(), seed=11)
    train_state_from_jax(r["state"], teng)
    assert (teng.step, teng.global_steps, teng.opt_state.count) == (2, 2, 2)
    # the live TrainState (a NamedTuple of numpy leaves) carries the same
    live = port_engine(config(), seed=12)
    train_state_from_jax(r["live"], live)
    assert_same_state(live, teng)
    jl, tl = [], []
    for b in r["data"][2:]:
        jl.append(float(r["engine"].train_batch(dict(b))["loss"]))
        tl.append(float(teng.train_batch(dict(b))["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    want = jax.tree.map(np.asarray, r["engine"].fp32_params())
    got = params_to_numpy(teng.fp32_params())
    errs = {f"layers.{k}": rel_norm(got["layers"][k], v)
            for k, v in want["layers"].items() if k != "bk"}
    errs.update({k: rel_norm(got[k], v) for k, v in want.items()
                 if k != "layers"})
    assert max(errs.values()) <= TOL, errs


def test_port_refuses_jax_and_host_layout_tags(jax_run, tmp_path):
    eng = port_engine(config(), seed=1)
    with pytest.raises(ValueError, match="train_state_from_jax"):
        eng.load_checkpoint(str(jax_run["base"]))
    eng.save_checkpoint(tmp_path)
    meta = tmp_path / "global_step0" / "meta.json"
    meta.write_text(json.dumps({**json.loads(meta.read_text()),
                                "layout": "host"}))
    with pytest.raises(NotImplementedError, match="item 6"):
        eng.load_checkpoint(tmp_path)


def test_both_converters_read_across(jax_run, tmp_path):
    """JAX's converter output read by the port equals the JAX master at the
    save; the port's read by the safetensors package (and the port) equals
    the port engine's master; JAX's model_config_from_meta rebuilds the
    port config from the port's meta.json."""
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    r = jax_run
    tcfg = torch_presets.tiny_test(dtype=torch.float32, max_seq=64)
    jax_to_fp32.convert(r["base"], None, str(tmp_path / "jax_out"),
                        fmt="safetensors")
    got = read_fp32_safetensors(tmp_path / "jax_out" /
                                "model_fp32.safetensors", tcfg)
    want = params_from_jax(r["master"], tcfg)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    eng = port_engine(config(), seed=5)
    eng.train_batch(dict(batches(1)[0]))
    eng.save_checkpoint(tmp_path / "port")
    port_to_fp32.main([str(tmp_path / "port"), "latest",
                       str(tmp_path / "port_out")])
    out = tmp_path / "port_out" / "model_fp32.safetensors"
    flat = safetensors_numpy.load_file(str(out))
    master = eng.fp32_params()
    assert set(flat) == {k.replace(".", "/") for k in master}
    for k, v in master.items():
        assert np.array_equal(flat[k.replace(".", "/")], v.numpy()), k
    back = read_fp32_safetensors(out, tcfg)
    assert all(torch.equal(back[k], master[k]) for k in master)
    assert json.loads((tmp_path / "port_out" / "native_config.json")
                      .read_text())["dtype"] == "float32"

    meta = json.loads((tmp_path / "port" / "global_step1" / "meta.json")
                      .read_text())
    assert meta["layout"] == "device" and meta["global_steps"] == 1
    assert meta["param_count"] == r["engine"].param_count
    assert set(meta) >= set(json.loads(
        (r["base"] / "global_step2" / "meta.json").read_text()))
    jcfg = jax_to_fp32.model_config_from_meta(meta)
    pcfg = port_to_fp32.model_config_from_meta(meta)
    assert pcfg == eng.model.cfg
    for f in dataclasses.fields(pcfg):
        a, b = getattr(jcfg, f.name), getattr(pcfg, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).removeprefix("torch.")
        else:
            assert a == b, f.name
    with pytest.raises(NotImplementedError, match="item 8"):
        port_to_fp32.convert(str(tmp_path / "port"), fmt="hf")


# ------------------------------------------- sentinel and auto-resume
def test_nonfinite_sentinel_halts():
    """K consecutive bad steps raise the typed halt; a good step resets the
    streak (JAX ``test_nonfinite_sentinel_halts``), and the boundary hook
    counts a non-finite loss as a bad window."""
    eng = port_engine(config(), seed=1)
    eng._max_bad_steps, eng._bad_step_streak = 4, 0
    eng._note_bad_steps(True, 2, float("nan"))
    eng._note_bad_steps(False, 2, 1.5)
    assert eng._bad_step_streak == 0
    eng._note_bad_steps(True, 2, float("nan"))
    with pytest.raises(dt.NonFiniteLossError) as ei:
        eng._note_bad_steps(True, 2, float("inf"))
    assert ei.value.streak == 4 and np.isinf(ei.value.last_loss)
    eng._bad_step_streak, eng._max_bad_steps = 0, 10 ** 6
    eng._sentinel_at_boundary(1.25)
    assert eng._bad_step_streak == 0
    eng._sentinel_at_boundary(float("nan"))
    assert eng._bad_step_streak == int(eng.config.steps_per_print)


def test_sentinel_halts_a_run_that_only_skips(tmp_path):
    """fp16 at a scale that overflows every step, a report every step and
    K = 2: the second train_batch halts; after a save and a load the
    sentinel starts from the restored history, not from 0."""
    conf = config("float16", steps_per_print=1,
                  fp16={"enabled": True, "initial_scale_power": 100,
                        "hysteresis": 1},
                  resilience={"max_consecutive_bad_steps": 2})
    eng = port_engine(conf, seed=1, dtype=torch.float16)
    data = batches(3)
    eng.train_batch(dict(data[0]))
    eng.save_checkpoint(tmp_path)
    with pytest.raises(dt.NonFiniteLossError):
        eng.train_batch(dict(data[1]))
    again = port_engine(conf, seed=2, dtype=torch.float16)
    again.load_checkpoint(tmp_path)
    assert again._skipped_total_prev == 1.0 and again._bad_step_streak == 0
    again.train_batch(dict(data[1]))                 # one bad window: streak 1
    assert again._bad_step_streak == 1


def test_resume_auto(tmp_path):
    with pytest.raises(ValueError, match="resume_dir"):
        port_engine(config(resilience={"resume": "auto"}), seed=1)
    conf = config(resilience={"resume": "auto",
                              "resume_dir": str(tmp_path / "empty")})
    fresh = port_engine(conf, seed=1)
    assert fresh.global_steps == 0
    fresh.train_batch(dict(batches(1)[0]))
    fresh.save_checkpoint(tmp_path / "empty")
    resumed = port_engine(conf, seed=2)
    assert resumed.global_steps == 1
    assert_same_state(resumed, fresh)
