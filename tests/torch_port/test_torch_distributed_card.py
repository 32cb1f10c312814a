"""The distributed path on the card (no JAX: the GPU machine has none).

A one-rank NCCL group (a FileStore, no network) holds a 1x1 mesh for the
module's tests and is destroyed after them.  The three steps at smoke size
against the undistributed path; the kernels' operators under
`FakeTensorMode` (shapes only, nothing launched); K2 through `local_map`.
Skipped without a card."""
import dataclasses
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

TOL = 2e-5  # fp32 (tests/test_kernels.py)


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels have no CPU mode")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)  # the rank's device, before the mesh (NCCL)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="nccl_"), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_local_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def _setup(kind, B=2, S=32):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32).cuda()
    return cfg, model, params, {"tokens": tokens}, ShapeConfig(kind, S, B, kind)


def _err(a, b) -> float:
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    return float((a.float() - b.float()).abs().max())


def test_train_step_matches_undistributed(cuda_device, mesh):
    from repro_torch.distributed import steps
    from repro_torch.launch.train import train_step
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg, model, params, batch, shape = _setup("train")
    b = steps.make_train_step(cfg, mesh, shape)
    # the step updates its (aliased) parameters in place: the reference run
    # starts from a copy
    ref = tree_unflatten(tree_structure(params), [t.clone() for _, t in flatten_params(params)])
    new, _, loss = b.fn(*b.place(params, init_opt_state(params), batch))
    ref_new, _, ref_loss, _ = train_step(model, ref, init_opt_state(ref), batch, AdamWConfig(),
                                         remat=True)
    assert abs(float(loss.full_tensor()) - float(ref_loss)) <= TOL
    for (n, a), (_, w) in zip(flatten_params(new), flatten_params(ref_new)):
        assert _err(a, w) <= 1e-6, n


def test_prefill_step_runs_k2_through_local_map(cuda_device, mesh):
    from repro_torch.distributed import steps
    from repro_torch.kernels import ops

    cfg, model, params, batch, shape = _setup("prefill")
    b = steps.make_prefill_step(cfg, mesh, shape)
    args = b.place(params, batch)
    before = ops.launch_counts()["flash_attention"]
    last, cache = b.fn(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] - before == cfg.num_layers
    with torch.no_grad():
        logits, ref_cache = model.prefill(params, batch, cache_cap=shape.seq_len)
    assert _err(last, logits[:, -1]) <= TOL
    from repro_torch.models.tensors import flatten_params

    for (n, a), (_, w) in zip(flatten_params(cache), flatten_params(ref_cache)):
        assert _err(a, w) <= TOL, n


def test_serve_step_matches_decode(cuda_device, mesh):
    from repro_torch.distributed import steps

    cfg, model, params, batch, shape = _setup("decode")
    b = steps.make_serve_step(cfg, mesh, shape)
    data = model.make_batch(torch.Generator().manual_seed(2), shape, device="cuda")
    logits, _ = b.fn(*b.place(params, data["token"], data["pos"], data["cache"]))
    with torch.no_grad():
        ref, _ = model.decode(params, data["token"], data["pos"], data["cache"])
    assert _err(logits, ref) <= TOL


def test_kernel_ops_trace_under_fake_mode(cuda_device):
    """On fake CUDA tensors the operators give shapes and launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops

    before = ops.launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 64, 8, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, device="cuda")
        assert ops.flash_attention(q, k, k).shape == q.shape
        qd = torch.empty(2, 8, 64, dtype=torch.bfloat16, device="cuda")
        pages = torch.empty(16, 16, 2, 64, dtype=torch.bfloat16, device="cuda")
        tables = torch.empty(2, 4, dtype=torch.int32, device="cuda")
        lengths = torch.empty(2, dtype=torch.int32, device="cuda")
        assert ops.paged_attention(qd, pages, pages, tables, lengths).shape == qd.shape
    assert ops.launch_counts() == before


def test_sharded_attention_launches_k2_locally(cuda_device, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.models.sharded import attention

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen).to("cuda", torch.bfloat16)
               for s in ((2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    place = lambda t: distribute_tensor(t, mesh, [Replicate(), Replicate()])  # noqa: E731
    before = ops.launch_counts()["flash_attention"]
    out = attention(lambda a, b, c, p: ops.flash_attention(a, b, c), place(q), place(k),
                    place(v), torch.zeros(2, 128, dtype=torch.int32, device="cuda"))
    assert ops.launch_counts()["flash_attention"] - before == 1
    assert torch.equal(out.full_tensor(), ops.flash_attention(q, k, v))
