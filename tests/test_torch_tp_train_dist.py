"""deepspeed_tpu_torch tensor- and expert-parallel training against the JAX
engine, on the CPU.

One ``gloo`` spawn per world (2, then 4; ``tests/torch_tp_train_worker.py``),
set up once for the module: every rank runs every case of its world
through ``initialize(config, model)`` with ``mesh.model`` / ``mesh.expert``
at ZeRO stages 0-3, while this process runs the JAX ``Engine`` of each
case on a mesh of the same shape over its first W CPU devices
(``build_mesh(MeshSpec(data=D, expert=E, model=M),
devices=jax.devices()[:W])``), from the same fp32 weights on the same
global batches, 3 steps.

Tolerances (fp32): losses and grad norms within 1e-5 relative at each
step; every gathered master leaf within 1e-5 relative in norm
(``layers.bk`` left out: its grad is 0 in exact arithmetic,
``tests/test_torch_train.py``), GSPMD's contiguous cut of a GQA model's
``wk`` / ``wv`` and the port's head-aligned one compared as whole leaves;
the MoE aux loss within 1e-5 relative and each rank's expert-bank shard
at init equal to the block JAX keeps on device r, byte for byte. A
vocabulary that ``tp`` does not divide (257) is held to JAX on one device
(JAX cannot place it cut over ``model``). ``fused_token_nll_tp`` alone, at
world 4, against JAX's under ``shard_map`` (``tests/unit/test_xent.py``'s
pattern): the NLL, dx, each rank's dW rows and db within 1e-5 of max |ref|,
targets outside the vocabulary included, and not scaled by ``tp`` (equal
to the whole-vocabulary plain version's, and to the plain spelling's
autograd through each rank's logits). Port against port: ``remat:
save_names`` within 1e-5 relative of no remat; a resume after 2 steps bit
for bit the run without the break. ``forward()`` of a ``tensor_parallel:
2`` inference engine: logits within 1e-5 of max |logit| of JAX's.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as ds
import torch_tp_train_worker as ttw
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.ops.xent import fused_token_nll_tp as jax_nll_tp
from deepspeed_tpu.platform.mesh import MeshSpec, build_mesh

from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import params_to_numpy
from deepspeed_tpu_torch.ops.xent import xent_bwd_plain, xent_fwd_plain
from deepspeed_tpu_torch.platform.mesh import AXIS_ORDER, BATCH_AXES, Mesh
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5
JOIN_S = 400
# cases JAX cannot place on the case's mesh: held to JAX on one device
JAX_ONE_DEVICE = ("odd_vocab",)
PORT_ONLY = ("remat_m2_s0",)


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


def _jax_cfg(name):
    fn, over = ttw.MODELS[name]
    if fn == "tiny_test":
        return jax_presets.tiny_test(max_seq=64, dtype=jnp.float32, **over)
    return getattr(jax_presets, fn)("tiny", vocab_size=ttw.VOCAB, n_layer=2,
                                    max_seq=64, dtype=jnp.float32, **over)


def jax_case(world, case) -> dict:
    name, mesh, stage, over = ttw.CASES[world][case]
    conf = ttw.config(mesh, stage, **over)
    conf.pop("mesh")
    if name in JAX_ONE_DEVICE:
        jmesh = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    else:
        jmesh = build_mesh(MeshSpec(data=mesh.get("data", 1),
                                    expert=mesh.get("expert", 1),
                                    model=mesh.get("model", 1)),
                           devices=jax.devices()[:world])
    jm = jax_build(_jax_cfg(name))
    eng = ds.initialize(conf, jm, mesh=jmesh,
                        params=params_to_numpy(ttw.initial_params(name)))
    devices = jax.devices()[:world]
    banks = {}
    for k, arr in _flat(eng.state.master_params).items():
        if k.split(".")[-1] in ("w_in", "w_out", "w_gate", "b_in", "b_out") \
                and ttw.MODELS[name][0] == "mixtral":
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            banks[k] = [by_dev[d] for d in devices]
    steps = []
    for b in ttw.global_batches(ttw.dp_size(mesh)):
        m = eng.train_batch(dict(b))
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"steps": steps, "master": _flat(eng.fp32_params()),
           "banks": banks}
    if _jax_cfg(name).num_experts > 1:
        _, aux = jm.apply(eng.fp32_params(), jnp.asarray(ttw.eval_ids()),
                          return_aux=True)
        out["aux"] = float(aux)
    return out


def jax_forward(world) -> np.ndarray:
    name, tp = ttw.FORWARD[world]
    mesh = build_mesh(MeshSpec(data=1, model=tp),
                      devices=jax.devices()[:tp])
    eng = ds.init_inference(jax_build(_jax_cfg(name)),
                            params_to_numpy(ttw.initial_params(name)),
                            {"dtype": "float32", "tensor_parallel": tp},
                            mesh=mesh)
    return np.asarray(eng.forward(jnp.asarray(ttw.eval_ids())))


def jax_xent(world) -> dict:
    """JAX's ``fused_token_nll_tp`` under ``shard_map`` on a ``model`` mesh
    of ``world`` devices (interpret mode): the NLL and the grads of the
    summed NLL in x, the whole table and the bias."""
    mesh = build_mesh(MeshSpec(data=1, model=world),
                      devices=jax.devices()[:world])
    out = {}
    for bias in (False, True):
        x, w, b, t = (None if a is None else jnp.asarray(a)
                      for a in ttw.xent_inputs(bias))

        def nll(x, w, b, t=t):
            if b is None:
                fn = jax.shard_map(
                    lambda x_, w_, t_: jax_nll_tp(x_, w_, None, t_, "model",
                                                  8, 32, True),
                    mesh=mesh, in_specs=(P(), P("model", None), P()),
                    out_specs=P(), check_vma=False)
                return fn(x, w, t)
            fn = jax.shard_map(
                lambda x_, w_, b_, t_: jax_nll_tp(x_, w_, b_, t_, "model",
                                                  8, 32, True),
                mesh=mesh, in_specs=(P(), P("model", None), P("model"), P()),
                out_specs=P(), check_vma=False)
            return fn(x, w, b, t)

        args = (x, w) + ((b,) if bias else ())
        grads = jax.grad(lambda *a: jnp.sum(nll(a[0], a[1],
                                                a[2] if bias else None)),
                         argnums=tuple(range(len(args))))(*args)
        out[bias] = {"nll": np.asarray(nll(x, w, b)),
                     "dx": np.asarray(grads[0]), "dw": np.asarray(grads[1]),
                     "db": np.asarray(grads[2]) if bias else None}
    return out


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
    out = tmp_path_factory.mktemp("tp_train_out")
    port, jx = {}, {}
    for world in (2, 4):
        procs = ttw.spawn(world, _free_port(), out)
        try:
            for case in ttw.CASES[world]:
                if case not in PORT_ONLY:
                    jx[world, case] = jax_case(world, case)
            if world in ttw.FORWARD:
                jx[world, "forward"] = jax_forward(world)
            if world == 4:
                jx[world, "xent"] = jax_xent(world)
        finally:
            ttw.join(procs, JOIN_S)
        port[world] = _load(out, world)
    return {"port": port, "jax": jx}


TRAIN = [(w, c) for w in (2, 4) for c in ttw.CASES[w] if c not in PORT_ONLY]


@pytest.mark.parametrize("world,case", TRAIN,
                         ids=[f"w{w}-{c}" for w, c in TRAIN])
def test_losses_and_grad_norms_match_jax(runs, world, case):
    want = runs["jax"][world, case]["steps"]
    for rank in runs["port"][world]:
        got = rank["train"][case]["steps"]
        assert len(got) == len(want) == ttw.STEPS
        for (gl, gn), (wl, wn) in zip(got, want):
            assert gl == pytest.approx(wl, rel=TOL)
            assert gn == pytest.approx(wn, rel=TOL)


@pytest.mark.parametrize("world,case", TRAIN,
                         ids=[f"w{w}-{c}" for w, c in TRAIN])
def test_gathered_masters_match_jax(runs, world, case):
    want = runs["jax"][world, case]["master"]
    for rank in runs["port"][world]:
        got = rank["train"][case]["master"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            if k != "layers.bk":
                assert rel_norm(got[k], w) <= TOL, k


def test_fused_head_routes_as_jax(runs):
    """A tied head with ``fused_xent`` takes ``fused_token_nll_tp`` at
    model 2 and 4; 257 rows, which 2 does not divide, the unfused head."""
    for world, case, want in ((2, "fused_m2_s1", True),
                              (4, "fused_m4_s1", True),
                              (2, "odd_m2_s2", False)):
        for rank in runs["port"][world]:
            assert rank["train"][case]["fused"] is want, (world, case)


@pytest.mark.parametrize("world,case", [(2, "moe_e2_s1"),
                                        (4, "moe_e2m2_s1")])
def test_moe_aux_loss_and_bank_shards_match_jax(runs, world, case):
    jx = runs["jax"][world, case]
    cut = 0
    for r, rank in enumerate(runs["port"][world]):
        res = rank["train"][case]
        assert res["aux"] == pytest.approx(jx["aux"], rel=TOL)
        assert set(res["init_banks"]) == set(jx["banks"])
        for k, blocks in jx["banks"].items():
            np.testing.assert_array_equal(res["init_banks"][k], blocks[r],
                                          err_msg=f"{r} {k}")
            cut += res["init_banks"][k].shape != jx["master"][k].shape
    assert cut > 0


def test_remat_save_names_matches_no_remat(runs):
    for rank in runs["port"][2]:
        got = rank["train"]["remat_m2_s0"]["steps"]
        want = rank["train"]["dense_m2_s0"]["steps"]
        for (gl, gn), (wl, wn) in zip(got, want):
            assert gl == pytest.approx(wl, rel=TOL)
            assert gn == pytest.approx(wn, rel=TOL)


def test_resume_is_bit_identical(runs):
    for r, rank in enumerate(runs["port"][2]):
        res = rank["resume"]
        assert res["resumed"] == res["straight"]
        assert res["step"] == 4
        for k, w in res["want"].items():
            np.testing.assert_array_equal(res["got"][k], w, err_msg=k)
        # each model coordinate writes its own cut
        for g in ("master", "mu", "nu"):
            for m in range(2):
                assert f"{g}.model{m}.expert0.safetensors" in res["files"]


def test_sharded_forward_matches_jax(runs):
    want = runs["jax"][2, "forward"]
    for rank in runs["port"][2]:
        got = rank["forward"]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_fused_token_nll_tp_matches_jax_shard_map(runs, bias):
    want = runs["jax"][4, "xent"][bias]
    world = 4
    rows = ttw.XENT["V"] // world
    x, w, b, t = ttw.xent_inputs(bias)
    tx = [torch.tensor(a) if a is not None else None for a in (x, w, b)]
    _, lse = xent_fwd_plain(tx[0], tx[1], tx[2], torch.as_tensor(t))
    dx1, dw1, db1 = xent_bwd_plain(tx[0], tx[1], tx[2], torch.as_tensor(t),
                                   lse, torch.ones(len(t)))
    for r, rank in enumerate(runs["port"][world]):
        got = rank["xent"][bias]
        sl = slice(r * rows, (r + 1) * rows)
        pairs = [("nll", got["nll"], want["nll"]), ("dx", got["dx"],
                                                     want["dx"]),
                 ("dw", got["dw"], want["dw"][sl])]
        if bias:
            pairs.append(("db", got["db"], want["db"][sl]))
        for what, g, wt in pairs:
            assert g.shape == wt.shape, what
            assert np.abs(g - wt).max() <= TOL * np.abs(wt).max(), (r, what)
        # the gradients are the whole-vocabulary function's: not scaled by
        # tp in either direction
        np.testing.assert_allclose(got["dx"], dx1.numpy(), rtol=0,
                                   atol=TOL * float(dx1.abs().max()))
        np.testing.assert_allclose(got["dw"], dw1[sl].numpy(), rtol=0,
                                   atol=TOL * float(dw1.abs().max()))
        if bias:
            np.testing.assert_allclose(got["db"], db1[sl].numpy(), rtol=0,
                                       atol=TOL * float(db1.abs().max()))
        # and the plain spelling's, autograd through the logits and the
        # collectives, gives the hand-written backward's
        plain = rank["xent"][("plain", bias)]
        for what in ("nll", "dx", "dw") + (("db",) if bias else ()):
            ref = np.abs(plain[what]).max()
            assert np.abs(got[what] - plain[what]).max() <= TOL * ref, what


@pytest.mark.parametrize("world", [2, 4])
def test_tp_train_collectives_count_a_rank_step(runs, world):
    """``chip_smoke.tp_train_collectives`` gives what a rank of the spawn
    recorded in ``comm.issued`` over one step (all-to-alls at world 4)."""
    case = ttw.COUNTED[world]
    for rank in runs["port"][world]:
        res = rank["train"][case]
        assert res["issued"] == res["reckoned"]
        assert res["issued"].get("allreduce", 0) > 0
    if world == 4:
        assert runs["port"][4][0]["train"][case]["issued"]["alltoall"] > 0


def test_config_accepts_model_and_expert():
    cfg = Config.from_any({"mesh": {"data": 2, "model": 2, "expert": 2}})
    assert (cfg.mesh.model, cfg.mesh.expert) == (2, 2)
    for axis in ("pipe", "seq"):
        with pytest.raises(NotImplementedError, match="item 8"):
            Config.from_any({"mesh": {axis: 2}})


@pytest.mark.parametrize("preset,tp,ep", [
    ("llama2", 4, 1), ("mixtral", 2, 2), ("tiny_test", 2, 1)],
    ids=["gqa_kv_shared_m4", "moe_e2_m2", "dense_m2"])
def test_gather_rank_shards_inverts_rank_shard(preset, tp, ep):
    """Every rank's cut of a whole state (``rank_shard``) gathers back into
    the whole leaves bit for bit, KV heads that several ranks hold
    included."""
    from deepspeed_tpu_torch.models import (TPLayout, build_model,
                                            gather_rank_shards, llama2,
                                            mixtral, rank_shard, tiny_test)

    cfg = {"llama2": lambda: llama2("tiny", n_kv_head=2),
           "mixtral": lambda: mixtral("tiny"), "tiny_test": tiny_test}[
        preset]()
    whole = build_model(cfg).init(torch.Generator().manual_seed(3),
                                  device="cpu", dtype=torch.float32)
    shards = {(m, e): rank_shard(whole, cfg, TPLayout.at(cfg, tp, ep, m, e))
              for m in range(tp) for e in range(ep)}
    back = gather_rank_shards(shards, cfg, tp, ep)
    assert back.keys() == whole.keys()
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    if cfg.kv_heads < tp:
        assert shards[(0, 0)]["layers.wk"].shape[-1] == cfg.head_dim


def test_mesh_groups_the_joint_batch_lines():
    """Under ``model`` > 1, ``mesh.group`` of the batch axes (and their
    parts) is the group of the rank's joint line: the ranks that share
    its ``model`` coordinate."""
    from deepspeed_tpu_torch.platform import mesh as pm

    for line in (("data", "zero", "expert"), ("data", "zero"),
                 ("data", "expert")):
        assert line in pm._LINES
    shape = {a: 1 for a in AXIS_ORDER}
    shape.update(data=2, expert=2, model=2)
    groups = {("data", "expert"): "batch", ("data",): "d",
              ("expert",): "e", ("model",): "m"}
    for rank in range(8):
        m = Mesh(shape, rank, active=True, groups=groups)
        assert m.group(BATCH_AXES) == "batch"
        assert m.group(("data", "zero")) == "d"
        assert m.size(BATCH_AXES) == 4
        line = m.line_ranks(BATCH_AXES)
        assert rank in line and len(line) == 4
        assert {r % 2 for r in line} == {rank % 2}   # one model coordinate
