"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode), is
marked ``gpu`` and skips on a host without one. The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest

Tolerance: atol=rtol=1e-4 — FFMA in the kernel against cuBLAS, and float
atomics in the plain version's ``index_add_``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch.ops import fused_ggnn as tfg  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _problem(rng, n, d, e, scale=0.1):
    h0 = rng.standard_normal((n, d)).astype(np.float32)
    rcv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    snd = rng.integers(0, n, e).astype(np.int32)
    w = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    args = (h0, snd, rcv, w(d, d), w(d), w(d, 3 * d), w(3 * d),
            w(d, 3 * d), w(3 * d))
    return [torch.from_numpy(a).cuda() for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,e", [
    (37, 96, 90),       # unpadded odd sizes
    (2048, 128, 8192),  # the first ladder bucket's shape
    (300, 200, 900),    # two column tiles
    (60, 50, 150),      # width not a multiple of 4: padded to 52
])
def test_kernel_matches_plain_version(cuda, n, d, e):
    args = _problem(np.random.default_rng(n + d), n, d, e)
    before = tfg.n_launches
    with torch.inference_mode():
        got = tfg.fused_ggnn(*args, n_steps=5)
        want = tfg.fused_ggnn_reference(*args, n_steps=5)
    torch.cuda.synchronize()
    assert tfg.n_launches - before == tfg.launches_per_call(5)
    # FFMA in the kernel against cuBLAS and atomics in the plain version
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_unsorted_edges_and_zero_steps(cuda):
    args = _problem(np.random.default_rng(7), 50, 128, 200)
    perm = torch.randperm(200, generator=torch.Generator().manual_seed(0))
    shuffled = list(args)
    shuffled[1], shuffled[2] = args[1][perm.cuda()], args[2][perm.cuda()]
    # the kernel takes receiver-sorted edges: a stable sort of a hand-built
    # list keeps each receiver's messages in their list order
    order = torch.argsort(shuffled[2], stable=True)
    resorted = list(shuffled)
    resorted[1], resorted[2] = shuffled[1][order], shuffled[2][order]
    with torch.inference_mode():
        got = tfg.fused_ggnn(*resorted, n_steps=3)
        want = tfg.fused_ggnn_reference(*shuffled, n_steps=3)
        same = tfg.fused_ggnn(*args, n_steps=0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(same, args[0])


def _grads(args, g, n_steps):
    """The kernel's gradients of all seven inputs, through autograd."""
    leaves = [a.clone().requires_grad_(True) if i not in (1, 2) else a
              for i, a in enumerate(args)]
    out = tfg.fused_ggnn(*leaves, n_steps=n_steps)
    diff = [leaves[i] for i in (0, 3, 4, 5, 6, 7, 8)]
    return torch.autograd.grad(out, diff, g)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,e", [
    (37, 96, 90),       # unpadded odd sizes
    (2048, 128, 8192),  # the first ladder bucket's shape
    (300, 200, 900),    # two column tiles
    (60, 50, 150),      # width not a multiple of 4: padded to 52
])
def test_backward_kernel_matches_plain_version(cuda, n, d, e):
    rng = np.random.default_rng(n * 3 + d)
    args = _problem(rng, n, d, e)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    before = tfg.n_bwd_launches
    got = _grads(args, g, 5)
    torch.cuda.synchronize()
    assert tfg.n_bwd_launches - before == tfg.bwd_launches_per_call(5)
    want = tfg.fused_ggnn_backward_reference(*args, g, n_steps=5)
    for name, a, b in zip(("dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb"),
                          got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        # FFMA sums in the kernel against cuBLAS and index_add_'s atomics
        assert float((a - b).abs().max()) <= 1e-4 * max(scale, 1.0), name


@pytest.mark.gpu
def test_backward_kernel_is_bitwise_stable_and_empty_cases(cuda):
    rng = np.random.default_rng(11)
    args = _problem(rng, 500, 128, 2000)
    g = torch.from_numpy(rng.standard_normal((500, 128)).astype(np.float32)).cuda()
    first = _grads(args, g, 3)
    second = _grads(args, g, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    # no rounds: dL/dh0 is g and every weight gradient is zero
    zero = _grads(args, g, 0)
    assert torch.equal(zero[0], g)
    assert not any(t.any() for t in zero[1:])
    # no edges: the edge weight still gets no gradient from messages
    none = list(args)
    none[1], none[2] = args[1][:0], args[2][:0]
    got = _grads(none, g, 2)
    want = tfg.fused_ggnn_backward_reference(*none, g, n_steps=2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_xla_backward_and_unknown_values_raise_on_the_card(cuda):
    args = _problem(np.random.default_rng(8), 20, 32, 40)
    args[3].requires_grad_(True)
    with pytest.raises(ValueError, match="one backward"):
        tfg.fused_ggnn(*args, n_steps=1, bwd_kernel="xla")
    with pytest.raises(ValueError, match="bwd_kernel"):
        tfg.fused_ggnn(*args, n_steps=1, bwd_kernel="bogus")
    with torch.no_grad():  # scoring does not need the backward
        tfg.fused_ggnn(*args, n_steps=1, bwd_kernel="xla")


@pytest.mark.gpu
def test_golden_width_trainer_step_is_finite(cuda):
    from deepdfa_tpu_torch.config import ExperimentConfig, GGNNConfig
    from deepdfa_tpu_torch.data.graphs import batch_np, to_device
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.train.loop import Trainer
    from deepdfa_tpu_torch.train.metrics import ConfusionState

    cfg = ExperimentConfig(model=GGNNConfig(layout="fused"))  # width 128
    model = make_model(cfg.model, cfg.input_dim, device="cuda", seed=0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, cfg, pos_weight=2.0)
    state = trainer.init_state()
    graphs = random_dataset(64, seed=3, input_dim=cfg.input_dim)
    batch = to_device(batch_np(graphs, 65, 8192, 16384), "cuda")
    fwd, bwd = tfg.n_launches, tfg.n_bwd_launches
    state, metrics, loss, wsum = trainer.train_step(
        state, batch, ConfusionState.zeros("cuda"))
    torch.cuda.synchronize()
    assert tfg.n_launches - fwd == tfg.launches_per_call(cfg.model.n_steps)
    assert tfg.n_bwd_launches - bwd == tfg.bwd_launches_per_call(
        cfg.model.n_steps)
    assert bool(torch.isfinite(loss)) and float(wsum) == 64
    after = model.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    assert not torch.equal(after["ggnn.gru.x_proj.weight"],
                           before["ggnn.gru.x_proj.weight"])
    assert state.step == 1 and float(sum(metrics)) == 64


@pytest.mark.gpu
def test_pooling_backward_is_bitwise_stable(cuda):
    """Attention pooling's backward (segment softmax, gathers and segment
    sums over sorted graph slots) reduces in a fixed order on the card:
    two calls give the same bits."""
    from deepdfa_tpu_torch.models.ggnn import GlobalAttentionPooling

    rng = np.random.default_rng(12)
    n, d, g = 5000, 256, 257
    gidx = torch.from_numpy(np.sort(rng.integers(0, g, n)).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((g, d)).astype(np.float32))
    pool = GlobalAttentionPooling(d).cuda()

    def grads():
        x = h.cuda().requires_grad_(True)
        pooled, _ = pool(x, gidx.cuda(), mask.cuda(), g)
        return torch.autograd.grad(pooled, [x] + list(pool.parameters()),
                                   cot.cuda())

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _mega_problem(seed, hidden=8, n_steps=3):
    """A packed batch and a seeded megabatch model at a small width."""
    from deepdfa_tpu_torch.config import GGNNConfig
    from deepdfa_tpu_torch.data.graphs import to_device
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.ops.megabatch import pack_megabatches

    cfg = GGNNConfig(hidden_dim=hidden, n_steps=n_steps, num_output_layers=3,
                     layout="megabatch")
    model = make_model(cfg, 52, device="cuda", seed=seed)
    graphs = (random_dataset(30, seed=seed, input_dim=52, mean_nodes=8)
              + random_dataset(6, seed=seed + 1, input_dim=52, mean_nodes=40))
    pack = pack_megabatches(graphs, width=4 * hidden, n_steps=n_steps,
                            table_rows=4 * 52, embed_width=hidden,
                            n_head_layers=3)
    return model, to_device(pack.batches[0], "cuda")


@pytest.mark.gpu
def test_megabatch_kernel_matches_plain_version(cuda):
    from deepdfa_tpu_torch.models.ggnn import GGNN
    from deepdfa_tpu_torch.ops import megabatch as tmb

    model, batch = _mega_problem(3)
    before = tmb.n_launches
    with torch.inference_mode():
        got = model(batch)
        again = model(batch)
    torch.cuda.synchronize()
    assert tmb.n_launches - before == 2 * tmb.launches_per_call(3)
    assert torch.equal(got, again)
    with torch.inference_mode():
        seg = GGNN.forward(model, batch)  # the segment layout, same weights
    assert bool(torch.isfinite(got).all()) and got.shape == seg.shape
    # FFMA in the kernel against cuBLAS in the plain segment layout
    np.testing.assert_allclose(got.cpu().numpy(), seg.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_megabatch_gradients_match_and_repeat_bitwise(cuda):
    from deepdfa_tpu_torch.models.ggnn import GGNN

    model, batch = _mega_problem(5)

    def grads(forward):
        model.zero_grad(set_to_none=True)
        torch.sum(forward(model, batch) ** 2).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    mega = type(model).forward
    first, second = grads(mega), grads(mega)
    assert all(torch.equal(first[k], second[k]) for k in first)
    plain = grads(GGNN.forward)
    for k, want in plain.items():
        scale = float(want.abs().max())
        # the recompute runs B1/B2, the plain layout cuBLAS and torch ops
        assert float((first[k] - want).abs().max()) <= 1e-4 * max(scale, 1.0), k
