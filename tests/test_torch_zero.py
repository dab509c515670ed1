"""deepspeed_tpu_torch's ZeRO layout against the JAX package's, on the CPU.

- ``runtime/zero/partitioning.py``: every leaf of three models gets the
  same compute and master spec as JAX's ``ZeroPartitioner`` on the same
  meshes of the 8 CPU devices (data 2 / 4 / 8; data x zero 2 x 2 and 4 x
  2, bare or under hpZ / MiCS), stages 0-3, thresholds 0 and the default.
- The physical shard: rank r's :class:`Cut` of a leaf is the block JAX
  keeps on device r for the same spec (``addressable_shards``), exactly.
- The mesh: rank r's coordinates are device r's place in JAX's mesh.
- The config: the ``zero_optimization`` and ``mesh`` keys it accepts, and
  the hpZ / MiCS / qwZ errors of JAX's ``_mesh_spec``, raised alike.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import deepspeed_tpu_torch as dt
from deepspeed_tpu.config import Config as JaxConfig
from deepspeed_tpu.config.config import ZeroConfig as JaxZeroConfig
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.models import presets as jax_presets
from deepspeed_tpu.platform.mesh import MeshSpec as JaxMeshSpec
from deepspeed_tpu.platform.mesh import build_mesh as jax_mesh
from deepspeed_tpu.runtime.engine import Engine as JaxEngine
from deepspeed_tpu.runtime.zero.partitioning import \
    ZeroPartitioner as JaxPartitioner
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import presets as torch_presets
from deepspeed_tpu_torch.models.transformer import param_shapes, param_specs
from deepspeed_tpu_torch.platform.mesh import AXIS_ORDER, Mesh
from deepspeed_tpu_torch.runtime.engine import mesh_spec
from deepspeed_tpu_torch.runtime.zero.partitioning import (ZeroPartitioner,
                                                           stacked_fn)
from deepspeed_tpu_torch.runtime.zero.shards import spec_cut
from torch_one_thread import one_torch_thread  # noqa: F401

MODELS = {
    "tiny_test": ((), {}),
    "llama2": (("tiny",), dict(vocab_size=256, n_layer=2, max_seq=64)),
    "bert": (("tiny",), dict(vocab_size=320, max_seq=64, post_ln=True,
                             embed_norm=True, mlm_transform=True,
                             lm_head_bias=True)),
    # the 4-D expert banks and the router
    "mixtral": (("tiny",), dict(vocab_size=256, n_layer=2, max_seq=64)),
}
# (data, zero, hpZ size, MiCS size)
MESHES = [(2, 1, 1, 0), (4, 1, 1, 0), (8, 1, 1, 0), (2, 2, 1, 0),
          (2, 2, 2, 0), (4, 2, 2, 0), (2, 2, 0, 2), (4, 2, 0, 2)]


def _jax_specs(tree, rank_of) -> dict:
    """A JAX spec tree → port names → one tuple of axis names per dim."""
    flat = {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}
    out = {}
    for k, spec in flat.items():
        entries = [() if e is None else (tuple(e) if isinstance(
            e, (tuple, list)) else (e,)) for e in (spec or ())]
        out[k] = tuple(entries + [()] * (rank_of[k] - len(entries)))
    return out


def _jax_mesh(data, zero):
    return jax_mesh(JaxMeshSpec(data=data, zero=zero),
                    devices=jax.devices()[:data * zero])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "d%dz%d-hpz%d-mics%d"
                         % m)
@pytest.mark.parametrize("model", list(MODELS))
def test_every_leaf_gets_jax_spec(model, mesh):
    data, zero, hpz, mics = mesh
    args, kw = MODELS[model]
    jm = jax_build(getattr(jax_presets, model)(*args, **kw))
    tcfg = getattr(torch_presets, model)(*args, **kw)
    jmesh = _jax_mesh(data, zero)
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jshapes = jax.tree.map(lambda a: a.shape, abstract)
    shapes = param_shapes(tcfg)
    rank_of = {k: len(s) for k, s in shapes.items()}
    assert _jax_specs(jm.param_specs(), rank_of) == param_specs(tcfg)
    for stage in range(4):
        for threshold in (0, 10_000):
            jp = JaxPartitioner(JaxZeroConfig(
                stage=stage, param_persistence_threshold=threshold,
                zero_hpz_partition_size=max(hpz, 1), mics_shard_size=mics),
                jmesh)
            tp = ZeroPartitioner(stage, dict(jmesh.shape),
                                 param_persistence_threshold=threshold,
                                 zero_hpz_partition_size=max(hpz, 1),
                                 mics_shard_size=mics)
            assert (tp.hpz, tp.mics, tp.dp_axes) == (jp.hpz, jp.mics,
                                                     jp.dp_axes)
            st = jm.stacked_fn()
            specs = param_specs(tcfg)
            sf = stacked_fn(tcfg.n_layer)
            for what in ("compute_specs", "master_specs"):
                want = _jax_specs(getattr(jp, what)(jm.param_specs(), jshapes,
                                                    st), rank_of)
                got = getattr(tp, what)(specs, shapes, sf)
                assert got == want, (what, stage, threshold)
            grads = tp.grad_spec_tree(tp.master_specs(specs, shapes, sf))
            assert (grads is None) == (jp.grad_spec_tree({}) is None)


@pytest.mark.parametrize("mesh", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)],
                         ids=lambda m: "d%dz%d" % m)
def test_rank_shard_is_jax_device_shard(mesh):
    """Every rank's cut of every stage-3 leaf of tiny_test (threshold 0, the
    partition over data x zero) is the block JAX device r holds."""
    data, zero = mesh
    world = data * zero
    jmesh = _jax_mesh(data, zero)
    tcfg = torch_presets.tiny_test()
    shapes = param_shapes(tcfg)
    tp = ZeroPartitioner(3, dict(jmesh.shape), param_persistence_threshold=0)
    specs = tp.master_specs(param_specs(tcfg), shapes,
                            stacked_fn(tcfg.n_layer))
    devices = jax.devices()[:world]
    cut_leaves = 0
    for k, spec in specs.items():
        full = np.arange(np.prod(shapes[k]), dtype=np.float32) \
            .reshape(shapes[k])
        arr = jax.device_put(full, NamedSharding(jmesh, PartitionSpec(
            *[e if e else None for e in spec])))
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(world):
            m = Mesh(dict(jmesh.shape), rank=r, active=True)
            assert tuple(m.coords[a] for a in AXIS_ORDER) == tuple(
                int(i) for i in np.argwhere(jmesh.devices == devices[r])[0])
            cut = spec_cut(spec, m)
            got = full if cut is None else cut.shard(torch.as_tensor(full))
            np.testing.assert_array_equal(np.asarray(got), by_dev[devices[r]],
                                          err_msg=f"{k} rank {r}")
        cut_leaves += cut is not None
    assert cut_leaves > len(specs) // 2


ZERO_CONFIG = {"stage": 3, "param_persistence_threshold": "1e4",
               "reduce_bucket_size": "5e7", "overlap_comm": False,
               "contiguous_gradients": False, "zero_hpz_partition_size": 2,
               "zero_quantized_weights": True, "mics_shard_size": 0}


def test_config_accepts_the_zero_keys():
    cfg = Config.from_any({"zero_optimization": ZERO_CONFIG,
                           "mesh": {"data": 4, "zero": 2}})
    zc = cfg.zero_optimization
    assert (cfg.zero_stage, zc.param_persistence_threshold,
            zc.reduce_bucket_size, zc.overlap_comm,
            zc.zero_quantized_weights) == (3, 10_000, 50_000_000, False, True)
    assert (cfg.mesh.data, cfg.mesh.zero) == (4, 2)
    assert Config.from_any(cfg.to_dict()) == cfg
    jz = JaxConfig.from_any({"zero_optimization": ZERO_CONFIG})
    assert jz.zero_optimization.reduce_bucket_size == zc.reduce_bucket_size


@pytest.mark.parametrize("conf,item", [
    ({"zero_optimization": {"zero_quantized_gradients": True}}, "item 8"),
    ({"zero_optimization": {"offload_param": {"device": "cpu"}}}, "item 6"),
    ({"mesh": {"model": 2},
      "zero_optimization": {"zero_hpz_partition_size": 2}}, "item 4"),
    ({"mesh": {"pipe": 2}}, "item 8")])
def test_config_refuses_later_items(conf, item):
    with pytest.raises(NotImplementedError, match=item):
        Config.from_any(conf)


# mesh / zero_optimization -> JAX _mesh_spec's result or its error
MESH_CASES = [
    ({"data": 8}, {"zero_hpz_partition_size": 2}),
    ({"data": -1}, {"mics_shard_size": 4}),
    ({"data": 8, "zero": 2}, {}),
    ({"data": 4}, {"zero_hpz_partition_size": 2, "mics_shard_size": 2}),
    ({"data": 8}, {"zero_hpz_partition_size": 2, "mics_shard_size": 4}),
    ({"data": 6}, {"zero_hpz_partition_size": 4}),
    ({"data": 8, "zero": 4}, {"zero_hpz_partition_size": 2}),
    ({"data": 8, "zero": -1}, {}),
    ({"data": 8}, {"zero_quantized_weights": True}),
    ({"data": 8}, {"mics_shard_size": 2, "zero_quantized_weights": True}),
]


@pytest.mark.parametrize("mesh,zero", MESH_CASES)
def test_mesh_spec_matches_jax(mesh, zero):
    conf = {"mesh": mesh, "zero_optimization": {"stage": 2, **zero}}
    jcfg = JaxConfig.from_any(conf)
    fake = types.SimpleNamespace(config=jcfg)
    try:
        want = JaxEngine._mesh_spec(fake, jcfg.mesh)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_spec(Config.from_any(conf))
        assert str(got.value) == str(e)
        return
    got = mesh_spec(Config.from_any(conf))
    assert (got.data, got.zero) == (want.data, want.zero)


def test_engine_raises_the_mesh_errors_at_construction():
    model = dt.build_model(torch_presets.tiny_test(dtype=torch.float32))
    for zero, match in (
            ({"zero_hpz_partition_size": 2, "mics_shard_size": 4},
             "disagree"),
            ({"zero_quantized_weights": True}, "zero_quantized_weights"),
            ({"zero_hpz_partition_size": 4}, "not divisible")):
        with pytest.raises(ValueError, match=match):
            dt.initialize({"mesh": {"data": 6},
                           "zero_optimization": {"stage": 3, **zero}},
                          model, device="cpu")
    # one process, no world: a subgroup of 2 has no ranks to span
    with pytest.raises(ValueError, match="device count 1 not divisible"):
        dt.initialize({"zero_optimization": {"stage": 3,
                                             "zero_hpz_partition_size": 2}},
                      model, device="cpu")


def test_world_of_one_without_a_group_holds_every_leaf_whole():
    """No process group: stage 3 is the one-device engine, every leaf
    whole and no collective; the losses equal stage 0's bit for bit."""
    cfg = torch_presets.tiny_test(dtype=torch.float32, max_seq=64)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
    out = []
    for stage in (0, 3):
        e = dt.initialize({"train_batch_size": 8,
                           "train_micro_batch_size_per_gpu": 4,
                           "zero_optimization": {"stage": stage},
                           "bf16": {"enabled": False}},
                          dt.build_model(cfg), seed=1, device="cpu")
        assert all(p.master is None and p.compute is None
                   for p in e.plans.values())
        out.append([float(e.train_batch(dict(batch))["loss"])
                    for _ in range(2)])
    assert out[0] == out[1]


def test_jax_quantizer_copy_matches_jax():
    """The port's copy of ``rowwise_quant_int8`` / ``rowwise_dequant`` on
    rows with ties at .5 and an all-zero row."""
    from deepspeed_tpu.ops.quant import rowwise_dequant as jdq
    from deepspeed_tpu.ops.quant import rowwise_quant_int8 as jq
    from deepspeed_tpu_torch.runtime.zero.qwz import (rowwise_dequant,
                                                      rowwise_quant_int8)

    x = np.random.default_rng(0).normal(size=(6, 33)).astype(np.float32)
    x[1] = 0.0
    x[2, :3] = [127.0, 0.5, -1.5]
    q, s = rowwise_quant_int8(torch.as_tensor(x))
    wq, ws = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        rowwise_dequant(q, s, torch.float32).numpy(),
        np.asarray(jdq(wq, ws, jnp.float32)))

