"""deepspeed_tpu_torch multi-rank ZeRO against the JAX engine, on the CPU.

One ``gloo`` spawn per world (2, then 4; ``tests/torch_zero_worker.py``),
set up once for the module: every rank runs every case of its world and
saves what it saw, while this process runs the JAX ``Engine`` of each case
on a mesh of the same shape over its first W CPU devices
(``build_mesh(MeshSpec(data=D, zero=Z), devices=jax.devices()[:W])``),
from the same fp32 weights on the same global batches; rank r's rows are
JAX's column block r of each ``(gas, micro * W)`` slice.

Tolerances (fp32): losses and grad norms within 1e-5 relative, every
gathered master leaf within 1e-5 relative in norm (``layers.bk`` left out:
its grad is 0 in exact arithmetic, ``tests/test_torch_train.py``), and each
rank's master shard within 1e-5 of the JAX array's shard on device r, with
the same shape: a shard cut from another place differs by O(1). qwZ within
1e-4: a weight whose master differs by float noise can round to the
neighbouring int8 level on the other side, one quantum (max |row| / 127) of
difference in a compute weight. fp16 (stage 2, a dynamic loss scale): the
skipped steps and the scales exactly, losses within 2e-3 (fp16 compute,
summed in another order).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import torch_zero_worker as zw
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.ops.quant import rowwise_quant_int8 as jax_quant
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh
from deepspeed_tpu_torch.models import params_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5
TOL_QWZ = 1e-4
TOL_FP16_LOSS = 2e-3
JOIN_S = 300


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree) -> dict:
    return {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


def _jax_model(kind, **over):
    if kind == "tiny":
        cfg = jax_presets.tiny_test(max_seq=64, dtype=jnp.float32, **over)
    elif kind == "mixtral":
        cfg = jax_presets.mixtral("tiny", vocab_size=zw.VOCAB, n_layer=2,
                                  max_seq=64, dtype=jnp.float32, **over)
    else:
        cfg = jax_presets.llama2("tiny", vocab_size=zw.VOCAB, n_layer=2,
                                 max_seq=64, dtype=jnp.float32, **over)
    return jax_build(cfg)


def _mesh(world, conf):
    zc = conf["zero_optimization"]
    z = max(int(zc.get("zero_hpz_partition_size", 1)),
            int(zc.get("mics_shard_size", 0)), 1)
    return build_mesh(MeshSpec(data=world // z, zero=z),
                      devices=jax.devices()[:world])


def jax_case(world, kind, model_over, conf_over) -> dict:
    conf = zw.config(world, 0, **conf_over)
    params = params_to_numpy(zw.initial_params(zw.model_cfg(kind,
                                                            **model_over)))
    eng = ds.initialize(conf, _jax_model(kind, **model_over),
                        mesh=_mesh(world, conf), params=params)
    steps = []
    for b in zw.global_batches(world):
        m = eng.train_batch(dict(b))
        steps.append({k: float(v) for k, v in m.items()})
    ev = eng.eval_batch(zw.eval_batch(world))
    master = _flat(eng.state.master_params)
    devices = jax.devices()[:world]
    shards = {}
    for k, arr in master.items():
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        shards[k] = [by_dev[d] for d in devices]
    return {"steps": steps, "master": _flat(eng.fp32_params()),
            "shards": shards, "eval": ev}


def jax_train_state() -> dict:
    """A JAX ``TrainState`` after one step, as numpy leaves (the weights
    and moments ``train_state_from_jax`` carries into a stage-3 world)."""
    conf = zw.config(1, 0)
    eng = ds.initialize(conf, _jax_model("tiny"),
                        mesh=build_mesh(MeshSpec(data=1),
                                        devices=jax.devices()[:1]),
                        params=params_to_numpy(zw.initial_params(
                            zw.model_cfg("tiny"))))
    eng.train_batch(zw.global_batches(1, 1)[0])
    st = jax.tree.map(np.asarray, eng.state)
    return {"step": st.step, "skipped_steps": st.skipped_steps,
            "master_params": st.master_params,
            "opt_state": {"mu": st.opt_state.mu, "nu": st.opt_state.nu,
                          "count": st.opt_state.count},
            "loss_scale": {"scale": st.loss_scale.scale,
                           "good_steps": st.loss_scale.good_steps,
                           "hysteresis": st.loss_scale.hysteresis}}


def _load(out_dir, world):
    ranks = []
    for r in range(world):
        path = out_dir / f"w{world}_rank{r}.pt"
        if not path.exists():
            pytest.fail(f"world {world} rank {r} wrote no result")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            pytest.fail(f"world {world} rank {r}:\n{res['error']}")
        ranks.append(res)
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("zero_out")
    ckpt = tmp_path_factory.mktemp("zero_ckpt")
    state = jax_train_state()
    port, jax_res = {}, {"train_state": state}
    for world in (2, 4):
        procs = zw.spawn(world, _free_port(), out, ckpt,
                         state if world == 2 else None)
        try:
            for name, case in zw.CASES[world].items():
                jax_res[world, name] = jax_case(world, *case)
        finally:
            zw.join(procs, JOIN_S)
        port[world] = _load(out, world)
    return {"port": port, "jax": jax_res, "ckpt": ckpt}


CASES = [(w, n) for w in (2, 4) for n in zw.CASES[w]]
GATED = [c for c in CASES if c[1] != "fp16_s2"]


def _tol(name):
    return TOL_QWZ if name.startswith("qwz") else TOL


@pytest.mark.parametrize("world,name", GATED)
def test_losses_and_grad_norms_match_jax(runs, world, name):
    want = runs["jax"][world, name]["steps"]
    for rank in runs["port"][world]:
        got = rank[name]["steps"]
        for g, w in zip(got, want):
            assert g["loss"] == pytest.approx(w["loss"], rel=_tol(name))
            assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                                   rel=_tol(name))
            assert g["lr"] == pytest.approx(w["lr"], rel=1e-6, abs=1e-12)
            assert g["skipped"] == w["skipped"] == 0


@pytest.mark.parametrize("world,name", GATED)
def test_eval_loss_is_the_mean_over_ranks(runs, world, name):
    """``eval_batch`` after the steps, each rank on its block of the rows:
    the mean over the ranks is JAX's loss on the whole batch."""
    want = runs["jax"][world, name]["eval"]
    for rank in runs["port"][world]:
        assert rank[name]["eval"] == pytest.approx(want, rel=_tol(name))


@pytest.mark.parametrize("world,name", GATED)
def test_gathered_master_matches_jax(runs, world, name):
    want = runs["jax"][world, name]["master"]
    for rank in runs["port"][world]:
        got = rank[name]["full"]["master"]
        assert set(got) == set(want)
        errs = {k: rel_norm(got[k], want[k])
                for k in sorted(set(want) - {"layers.bk"})}
        assert max(errs.values()) <= _tol(name), errs


@pytest.mark.parametrize("world,name", GATED)
def test_master_shard_is_jax_shard_on_device_r(runs, world, name):
    """The layout oracle: rank r's master shard is the block JAX keeps on
    device r, leaf by leaf (its shape exactly, its values to float
    noise)."""
    want = runs["jax"][world, name]["shards"]
    cut = 0
    for r, rank in enumerate(runs["port"][world]):
        got = rank[name]["shards"]
        for k in sorted(want):
            assert got[k].shape == want[k][r].shape, (r, k)
            cut += got[k].shape != runs["jax"][world, name]["master"][k].shape
            if k != "layers.bk":
                assert rel_norm(got[k], want[k][r]) <= _tol(name), (r, k)
    stage = zw.CASES[world][name][2]["zero_optimization"].get("stage", 0)
    assert (cut > 0) == (stage >= 1)


@pytest.mark.parametrize("world,name", CASES)
def test_every_rank_reports_the_same_step(runs, world, name):
    first = runs["port"][world][0][name]["steps"]
    for rank in runs["port"][world][1:]:
        np.testing.assert_equal(rank[name]["steps"], first)   # nan == nan


def test_fp16_overflow_skipped_on_every_rank(runs):
    want = runs["jax"][2, "fp16_s2"]["steps"]
    for rank in runs["port"][2]:
        got = rank["fp16_s2"]["steps"]
        assert [g["skipped"] for g in got] == [w["skipped"] for w in want]
        assert [g["loss_scale"] for g in got] == \
            [w["loss_scale"] for w in want]
        assert got[0]["skipped"] == 1 and not all(g["skipped"] for g in got)
        for g, w in zip(got, want):
            assert g["loss"] == pytest.approx(w["loss"], rel=TOL_FP16_LOSS)


def test_qwz_payload_is_jax_quantizer_byte_for_byte(runs):
    """Each qwZ leaf's int8 payload and scales, quantized rank by rank from
    the master shards (a row split over ranks takes its max by an
    all-reduce), equal JAX's ``rowwise_quant_int8`` of the same whole
    master."""
    for rank in runs["port"][4]:
        res = rank["qwz_s3"]
        assert res["qwz"], "no leaf took the int8 gather"
        for k, (q, s) in res["qwz"].items():
            jq, js = jax_quant(jnp.asarray(res["full"]["master"][k]))
            np.testing.assert_array_equal(q, np.asarray(jq), err_msg=k)
            np.testing.assert_array_equal(s, np.asarray(js), err_msg=k)


def test_stage3_gathers_at_most_two_layers(runs):
    """6 layers, every leaf cut: at most two layers' gathered leaves alive
    at once, with and without remat, and the steps those of stage 0."""
    for rank in runs["port"][2]:
        b = rank["budget"]
        for remat in zw.BUDGET:
            s3, s0 = b[f"{remat}_s3"], b[f"{remat}_s0"]
            assert 1 <= s3["peak_layers"] <= 2, (remat, s3["peak_layers"])
            assert s0["peak_layers"] == 0
            for g, w in zip(s3["steps"], s0["steps"]):
                assert g["loss"] == pytest.approx(w["loss"], rel=1e-6)
                assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                                       rel=1e-5)
    for rank in runs["port"][4]:
        assert 1 <= rank["tiny_s3"]["peak_layers"] <= 2


def test_train_state_from_jax_lands_as_shards(runs):
    st = runs["jax"]["train_state"]
    for rank in runs["port"][2]:
        got = rank["from_jax"]
        for g, tree in (("master", st["master_params"]),
                        ("mu", st["opt_state"]["mu"]),
                        ("nu", st["opt_state"]["nu"])):
            for k, v in _flat(tree).items():
                np.testing.assert_array_equal(got[g][k], v, err_msg=f"{g} {k}")


def _equal_states(a, b):
    for g in ("master", "mu", "nu"):
        assert set(a[g]) == set(b[g])
        for k in a[g]:
            np.testing.assert_array_equal(a[g][k], b[g][k], err_msg=f"{g} {k}")


def test_stage3_tag_of_world2_loads_at_world1_and_world4(runs):
    import deepspeed_tpu_torch as dt

    saved = runs["port"][2][0]["ckpt"]["saved_s3"]
    for rank in runs["port"][4]:
        assert rank["ckpt"]["loaded_steps"] == 2
        _equal_states(rank["ckpt"]["loaded_s1"], saved)
    cfg = zw.model_cfg("tiny")
    one = dt.initialize(zw.config(1, 1), dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()), device="cpu")
    one.load_checkpoint(str(runs["ckpt"] / "s3"))
    _equal_states({"master": one.master, "mu": one.opt_state.mu,
                   "nu": one.opt_state.nu},
                  {g: {k: torch.as_tensor(v) for k, v in d.items()}
                   for g, d in saved.items()})


def test_async_save_and_auto_resume_at_world2(runs):
    for rank in runs["port"][2]:
        c = rank["ckpt"]
        assert c["async"]["verified"] == "verified"
        _equal_states(c["async"]["loaded"], c["async"]["held"])
        assert c["auto"]["global_steps"] == 1
        _equal_states(c["auto"]["state"], c["async"]["held"])


def test_tag_mismatch_raises_on_every_rank(runs):
    for rank in runs["port"][2]:
        assert rank["ckpt"]["mismatch"] and "differs across processes" \
            in rank["ckpt"]["mismatch"]


def test_preemption_guard_agrees_across_ranks(runs):
    """SIGTERM on rank 0 alone, an async save in flight: at the next step
    every rank sees the preemption and the save is committed."""
    for rank in runs["port"][2]:
        assert rank["ckpt"]["preempt"] == {"preempted": True,
                                           "committed": True}
    assert (runs["ckpt"] / "preempt" / "latest").read_text() \
        == "global_step1"
