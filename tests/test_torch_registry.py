"""The ops registry: every kernel wrapper's launch counter and every cached
split workspace are found through ``ops/registry.py``, which the serving
engine's CUDA graph reads around its capture."""

import torch

from deepspeed_tpu_torch.ops import (decode_attention, flash_attention,
                                     registry, sparse_attention, woq_matmul,
                                     xent)
from torch_one_thread import one_torch_thread  # noqa: F401

WRAPPERS = {
    "decode_attention": decode_attention.decode_attention,
    "woq_matmul": woq_matmul.woq_matmul,
    "woq_matmul_t": woq_matmul.woq_matmul_t,
    "flash_fwd": flash_attention.flash_fwd,
    "flash_bwd_dq": flash_attention.flash_bwd_dq,
    "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
    "xent_fwd": xent.xent_fwd,
    "xent_bwd": xent.xent_bwd,
    "sparse_fwd": sparse_attention.sparse_fwd,
    "sparse_bwd_dq": sparse_attention.sparse_bwd_dq,
    "sparse_bwd_dkv": sparse_attention.sparse_bwd_dkv,
}


def test_every_kernel_wrapper_is_counted():
    counts = registry.launch_counts()
    assert set(WRAPPERS) <= set(counts)
    for name, fn in WRAPPERS.items():
        assert counts[name] == fn.launches
    fn = WRAPPERS["woq_matmul_t"]
    before = fn.launches
    fn.launches += 3
    try:
        assert registry.launch_counts()["woq_matmul_t"] == before + 3
    finally:
        fn.launches = before


def test_workspace_grows_and_is_listed():
    ws = registry.Workspace()
    dev = torch.device("cpu")
    a, ta = ws(dev, 10, 4)
    assert a.dtype == torch.float32 and a.numel() == 10
    assert ta.dtype == torch.int32 and bool((ta == 0).all())
    b, tb = ws(dev, 8, 2)             # fits: the cached buffers come back
    assert b is a and tb is ta
    c, tc = ws(dev, 20, 2)            # grows the workspace, keeps tickets
    assert c is not a and c.numel() == 20 and tc is ta
    listed = registry.workspace_buffers()
    assert any(t is c for t in listed) and any(t is ta for t in listed)
    assert not any(t is a for t in listed)


def test_the_split_kernels_use_the_registry():
    for mod in (decode_attention, woq_matmul):
        assert isinstance(mod._scratch, registry.Workspace)
