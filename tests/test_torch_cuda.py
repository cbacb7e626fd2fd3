"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode), is
marked ``gpu`` and skips on a host without one. The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest

Tolerance: atol=rtol=1e-4 — the kernels' float32 sums (3xTF32 on the
tensor cores at widths 128, 192, 224 and 288, FFMA elsewhere) against
cuBLAS, and float atomics in the plain version's ``index_add_``; the
attention and bf16 int8 tests state their own.
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
    # the kernel's float32 sums against cuBLAS and atomics in the plain
    # version
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
    assert tfg.n_bwd_launches - before == tfg.bwd_launches_per_call(
        5, tfg.variant(d))
    want = tfg.fused_ggnn_backward_reference(*args, g, n_steps=5)
    for name, a, b in zip(("dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb"),
                          got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        # the kernel's float32 sums against cuBLAS and index_add_'s atomics
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


def _padded_problem(rng, n, e, sink_loops, d=128):
    """A batch_np-shaped problem: random receiver-sorted edges among the
    first nodes, then ``sink_loops`` padding edges sink -> sink (the last
    node), seeded weights of the golden model's scale."""
    snd = rng.integers(0, n - 1, e)
    rcv = np.sort(rng.integers(0, n - 1, e))
    snd = np.concatenate([snd, np.full(sink_loops, n - 1)]).astype(np.int32)
    rcv = np.concatenate([rcv, np.full(sink_loops, n - 1)]).astype(np.int32)
    w = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    args = (w(n, d, std=0.2), snd, rcv, w(d, d, std=d ** -0.5),
            w(d, std=0.1), w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1),
            w(d, 3 * d, std=d ** -0.5), w(3 * d, std=0.1))
    return [torch.from_numpy(a).cuda() for a in args]


# the kernel phase's shapes (serving ladder, megabatch) and the largest
# training bucket, each with its padding sink's run of self-loops
TC_SHAPES = [(2048, 1200, 6388), (4096, 3000, 5000), (5120, 3200, 17114),
             (16768, 30000, 5000)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,sink", TC_SHAPES)
def test_tensor_core_kernel_matches_plain_version(cuda, n, e, sink):
    args = _padded_problem(np.random.default_rng(n), n, e, sink)
    before = dict(tfg.n_variant_launches)
    with torch.inference_mode():
        got = tfg.fused_ggnn(*args, n_steps=5)
        again = tfg.fused_ggnn(*args, n_steps=5)
        want = tfg.fused_ggnn_reference(*args, n_steps=5)
        p = tfg._Prepared(args[0], args[1], args[2], args[3:], 1024)
        ffma = tfg._forward_cuda(p, 5, bank=False, kind="ffma")[0]
        ffma_again = tfg._forward_cuda(p, 5, bank=False, kind="ffma")[0]
    torch.cuda.synchronize()
    assert {k: tfg.n_variant_launches[k] - before[k]
            for k in tfg.VARIANTS} == {"wgmma": 2 * tfg.launches_per_call(5),
                                       "ffma": 2 * tfg.launches_per_call(5)}
    assert torch.equal(got, again) and torch.equal(ffma, ffma_again)
    # every row, the sink's included, against the plain version: float32
    # sums in other orders (the sink's row, whose aggregate is thousands of
    # times its message, is computed in the FFMA variant's arithmetic)
    for out in (got, ffma):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert torch.equal(got[n - 1], ffma[n - 1])


def _edge_sum_banks(p):
    """Both round kernels bank the aggregates of one round's messages of
    the prepared call ``p`` (direct launches at its width): returns the
    tensor-core edge linear's padding-sink flags, the tensor-core bank and
    the FFMA bank."""
    n, d = p.n, p.dp
    msg = p.h @ p.ew + p.eb
    lib = tfg._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    banks = []
    for kind in tfg.VARIANTS:
        row_ptr = torch.empty(n + 1, dtype=torch.int32, device="cuda")
        agg, out = torch.empty_like(p.h), torch.empty_like(p.h)
        w = [t.data_ptr() for t in (p.xw, p.xb, p.hw, p.hb)]
        if kind == "wgmma":
            heads = torch.empty(tfg.heads_words(p.e), dtype=torch.int32,
                                device="cuda")
            flags = torch.empty(n, dtype=torch.int32, device="cuda")
            assert lib.ggnn_tc_prep(p.rcv.data_ptr(), p.snd.data_ptr(), p.e,
                                    n, row_ptr.data_ptr(), heads.data_ptr(),
                                    d, stream) == 0
            assert lib.ggnn_tc_linear(p.h.data_ptr(), p.ew.data_ptr(),
                                      p.eb.data_ptr(), row_ptr.data_ptr(),
                                      p.snd.data_ptr(), heads.data_ptr(),
                                      flags.data_ptr(), out.data_ptr(), n, d,
                                      stream) == 0
            torch.cuda.synchronize()
            sink_flags = flags.clone()
            assert lib.ggnn_tc_round(p.h.data_ptr(), msg.data_ptr(),
                                     row_ptr.data_ptr(), p.snd.data_ptr(),
                                     heads.data_ptr(), flags.data_ptr(), *w,
                                     out.data_ptr(), agg.data_ptr(), n, d,
                                     stream) == 0
        else:
            assert lib.ggnn_csr(p.rcv.data_ptr(), p.e, n,
                                row_ptr.data_ptr(), stream) == 0
            assert lib.ggnn_gru_round(p.h.data_ptr(), msg.data_ptr(),
                                      row_ptr.data_ptr(), p.snd.data_ptr(),
                                      *w, out.data_ptr(), agg.data_ptr(), n,
                                      d, stream) == 0
        banks.append(agg)
    torch.cuda.synchronize()
    return sink_flags, banks[0], banks[1]


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,sink", TC_SHAPES[:1] + TC_SHAPES[2:3])
def test_tensor_core_edge_sum_is_the_serial_sum(cuda, n, e, sink):
    """Both round kernels bank the aggregates of one round's messages: the
    tensor-core variant's (runs in closed form, the sink's segment summed
    by the whole block) equal the FFMA variant's serial sums bitwise."""
    args = _padded_problem(np.random.default_rng(n + 1), n, e, sink)
    p = tfg._Prepared(args[0], args[1], args[2], args[3:], 1024)
    msg = p.h @ p.ew + p.eb
    want = torch.zeros_like(msg).index_add_(0, p.rcv.long(),
                                            msg[p.snd.long()])
    flags, tc, ffma = _edge_sum_banks(p)
    # the edge linear flags the padding sink's row, and only it
    assert torch.nonzero(flags).flatten().tolist() == [n - 1]
    assert torch.equal(tc, ffma)
    # and the serial sum is the plain version's up to index_add_'s atomics
    np.testing.assert_allclose(tc.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,sink", [(4224, 6000, 2000),
                                      (16768, 30000, 5000)])
def test_tensor_core_backward_matches_float64(cuda, n, e, sink):
    """B2's gradients against the plain backward evaluated in float64,
    over each gradient's largest magnitude (the smoke's GRAD_LIMIT), with a
    cotangent that is zero on the padding sink (as the pooling's is), on
    both variants; each variant bitwise repeatable."""
    rng = np.random.default_rng(n + 2)
    args = _padded_problem(rng, n, e, sink)
    g = rng.standard_normal((n, 128)).astype(np.float32) * 1e-3
    g[n - 1] = 0.0
    g = torch.from_numpy(g).cuda()
    exact = tfg.fused_ggnn_backward_reference(
        *(a.double() if a.is_floating_point() else a for a in args),
        g.double(), n_steps=5)
    before = dict(tfg.n_bwd_variant_launches)
    got = _grads(args, g, 5)
    again = _grads(args, g, 5)
    torch.cuda.synchronize()
    assert {k: tfg.n_bwd_variant_launches[k] - before[k]
            for k in tfg.VARIANTS} == {
        "wgmma": 2 * tfg.bwd_launches_per_call(5), "ffma": 0}
    p = tfg._Prepared(args[0], args[1], args[2], args[3:], 1024)
    _, states, aggs = tfg._forward_cuda(p, 5, bank=True)
    ffma = tfg._backward_cuda(p, states, aggs, g, kind="ffma")
    ffma_again = tfg._backward_cuda(p, states, aggs, g, kind="ffma")
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(ffma, ffma_again))
    for grads in (got, ffma):
        for name, a, r in zip(("dh0", "dew", "deb", "dxw", "dxb", "dhw",
                               "dhb"), grads, exact):
            rel = float((a.double() - r).abs().max()) / float(r.abs().max())
            assert rel <= 1e-4, (name, rel)


# the analysis families' widths (the subkeys with the interprocedural, the
# dataflow, or both kinds of family): N 5,760 (the families' largest
# training bucket, 180 node tiles of 32) and a ragged N that no node tile
# divides, each with its padding sink's run of self-loops
FAMILY_SHAPES = [(d, n, e, sink) for d in (192, 224, 288)
                 for n, e, sink in ((5760, 11904, 3000), (1000, 1800, 300))]


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,e,sink", FAMILY_SHAPES)
def test_family_width_kernel_matches_plain_version(cuda, d, n, e, sink):
    """B1 at a family width runs on the tensor-core variant, matches the
    plain version on every real row, repeats bitwise, and computes the
    padding sink's row bit for bit as the FFMA variant does. The sink's
    row is held to the FFMA variant's, not to the plain version's: it sums
    hundreds of self-loops into saturated gates, where the plain
    version's atomics (another order of the same adds) move it past
    float32-level agreement with either variant, and the smoke's bucket
    rows leave it out for that reason."""
    args = _padded_problem(np.random.default_rng(d + n), n, e, sink, d=d)
    before = dict(tfg.n_variant_launches)
    with torch.inference_mode():
        got = tfg.fused_ggnn(*args, n_steps=5)
        again = tfg.fused_ggnn(*args, n_steps=5)
        want = tfg.fused_ggnn_reference(*args, n_steps=5)
        p = tfg._Prepared(args[0], args[1], args[2], args[3:], 4096)
        ffma = tfg._forward_cuda(p, 5, bank=False, kind="ffma")[0]
    torch.cuda.synchronize()
    assert {k: tfg.n_variant_launches[k] - before[k]
            for k in tfg.VARIANTS} == {"wgmma": 2 * tfg.launches_per_call(5),
                                       "ffma": tfg.launches_per_call(5)}
    assert torch.equal(got, again)
    for out in (got, ffma):
        np.testing.assert_allclose(out[:-1].cpu().numpy(),
                                   want[:-1].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert torch.equal(got[n - 1], ffma[n - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,e,sink", [c for c in FAMILY_SHAPES
                                        if c[0] in (224, 288)])
def test_family_width_backward_matches_float64(cuda, d, n, e, sink):
    """B2 at 224 and 288 on the tensor-core variant against the plain
    backward in float64 (each gradient over its largest magnitude, the
    smoke's GRAD_LIMIT), bitwise on repeat."""
    rng = np.random.default_rng(d + n + 2)
    args = _padded_problem(rng, n, e, sink, d=d)
    g = rng.standard_normal((n, d)).astype(np.float32) * 1e-3
    g[n - 1] = 0.0
    g = torch.from_numpy(g).cuda()
    exact = tfg.fused_ggnn_backward_reference(
        *(a.double() if a.is_floating_point() else a for a in args),
        g.double(), n_steps=5)
    before = dict(tfg.n_bwd_variant_launches)
    got = _grads(args, g, 5)
    again = _grads(args, g, 5)
    torch.cuda.synchronize()
    assert {k: tfg.n_bwd_variant_launches[k] - before[k]
            for k in tfg.VARIANTS} == {
        "wgmma": 2 * tfg.bwd_launches_per_call(5), "ffma": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, a, r in zip(("dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb"),
                          got, exact):
        rel = float((a.double() - r).abs().max()) / float(r.abs().max())
        assert rel <= 1e-4, (name, rel)


@pytest.mark.gpu
def test_family_width_edge_sum_is_the_serial_sum(cuda):
    """At 224 the tensor-core round's aggregates (D / 4 float4 a row over
    two per lane, the sink's segment summed by the whole block) equal the
    FFMA variant's serial sums bitwise."""
    n, e, sink, d = 5760, 11904, 3000, 224
    args = _padded_problem(np.random.default_rng(7), n, e, sink, d=d)
    p = tfg._Prepared(args[0], args[1], args[2], args[3:], 4096)
    flags, tc, ffma = _edge_sum_banks(p)
    assert torch.nonzero(flags).flatten().tolist() == [n - 1]
    assert torch.equal(tc, ffma)


@pytest.mark.gpu
def test_family_width_call_replays_from_a_cuda_graph_bitwise(cuda):
    """At 288 one banked forward and its backward, captured in a CUDA
    graph, replay into the same bits as the eager calls."""
    n, e, sink, d = 5760, 11904, 3000, 288
    rng = np.random.default_rng(11)
    args = _padded_problem(rng, n, e, sink, d=d)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                         * 1e-3).cuda()
    p = tfg._Prepared(args[0], args[1], args[2], args[3:], 4096)

    def call():
        out, states, aggs = tfg._forward_cuda(p, 5, bank=True)
        return (out,) + tfg._backward_cuda(p, states, aggs, g)

    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.gpu
def test_family_width_megabatch_matches_plain_version(cuda):
    """B3 at 224 (four 56-wide sub-tables) runs B1's tensor-core rounds and
    matches the segment layout's plain forward."""
    from deepdfa_tpu_torch.models.ggnn import GGNN
    from deepdfa_tpu_torch.ops import megabatch as tmb

    model, batch = _mega_problem(3, hidden=56)
    before = dict(tmb.n_variant_launches)
    with torch.inference_mode():
        got = model(batch)
        again = model(batch)
        seg = GGNN.forward(model, batch)
    torch.cuda.synchronize()
    assert {k: tmb.n_variant_launches[k] - before[k]
            for k in tfg.VARIANTS} == {"wgmma": 2 * tmb.launches_per_call(3),
                                       "ffma": 0}
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), seg.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


class _FailingGgnnLib:
    """Stands in for B1's built library: every launch reports an error."""

    @staticmethod
    def ggnn_tc_prep(*args):
        return 700  # cudaErrorIllegalAddress

    ggnn_tc_linear = ggnn_tc_round = ggnn_csr = ggnn_tc_prep
    ggnn_linear = ggnn_gru_round = ggnn_tc_prep

    @staticmethod
    def ggnn_error_string(code):
        return b"an illegal memory access was encountered"


@pytest.mark.gpu
def test_family_width_failed_launch_raises(cuda, monkeypatch):
    """A refused tensor-core launch at 224 raises out of the public op;
    nothing falls back to the FFMA variant or the plain version."""
    args = _padded_problem(np.random.default_rng(5), 256, 512, 30, d=224)
    tfg._kernels()  # built, and its width limit read
    monkeypatch.setattr(tfg, "_fwd", _FailingGgnnLib())
    before = dict(tfg.n_variant_launches)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="tc_prep launch failed"):
            tfg.fused_ggnn(*args, n_steps=2)
    assert tfg.n_variant_launches == before


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



def _hier_problem(seed, device="cuda", hidden=8, n_steps=3):
    """A seeded golden-shaped model at a small width, its hierarchical
    scorer on ``device``, and graphs of mixed sizes."""
    from deepdfa_tpu_torch.config import GGNNConfig
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.models.ggnn_hier import HierScorer

    cfg = GGNNConfig(hidden_dim=hidden, n_steps=n_steps, layout="fused")
    state = make_model(cfg, 52, device="cpu", seed=seed).state_dict()
    scorer = HierScorer(cfg, 52, state, device=device)
    graphs = (random_dataset(40, seed=seed, input_dim=52, mean_nodes=12)
              + random_dataset(3, seed=seed + 1, input_dim=52, mean_nodes=300))
    return scorer, graphs


@pytest.mark.gpu
def test_encoder_kernel_matches_plain_version_and_rows_stand_alone(cuda):
    from deepdfa_tpu_torch.config import ALL_SUBKEYS
    from deepdfa_tpu_torch.data.graphs import batch_np
    from deepdfa_tpu_torch.ops import megabatch as tmb

    scorer, graphs = _hier_problem(7)
    (indices, plan), = scorer._pack(graphs)
    batch = batch_np([graphs[i] for i in indices], plan.max_graphs,
                     plan.max_nodes, plan.max_edges)
    before = tmb.n_launches
    together = scorer.embed_graphs(graphs)
    torch.cuda.synchronize()
    assert tmb.n_launches - before == tmb.launches_per_call(3)
    assert scorer.n_fallback_dispatches == 0
    ids = np.stack([batch.node_feats[f"_ABS_DATAFLOW_{sk}"] + i * 52
                    for i, sk in enumerate(ALL_SUBKEYS)], axis=-1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    args = (scorer._table, put(ids), put(batch.senders),
            put(batch.receivers), put(batch.node_gidx),
            put(batch.node_mask)) + scorer._weights
    kw = dict(n_steps=3, n_graphs=batch.max_graphs)
    with torch.inference_mode():
        got = tmb.fused_ggnn_encoder(*args, **kw)
        again = tmb.fused_ggnn_encoder(*args, **kw)
        want = tmb.megabatch_encoder_reference(*args, **kw)
    assert got.shape == (batch.max_graphs, 64) and torch.equal(got, again)
    # FFMA in the kernel against cuBLAS in the plain version
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    # each row is its graph's alone: every kernel works per node, per
    # receiver or per graph slot
    for i in (0, 17, 41):
        assert np.array_equal(scorer.embed_graphs([graphs[i]])[0],
                              together[i])


@pytest.mark.gpu
def test_hier_scorer_on_the_card_matches_the_cpu(cuda):
    from deepdfa_tpu_torch.models.ggnn_hier import UnitCallGraph, UnitFunction

    card, graphs = _hier_problem(9)
    cpu, _ = _hier_problem(9, device="cpu")
    for k, v in cpu.level2.state_dict().items():
        assert torch.equal(v, card.level2.state_dict()[k].cpu()), k
    fns = [UnitFunction(f"f{i}", f"int f{i};", g) for i, g in enumerate(graphs)]
    n = len(fns)
    unit = UnitCallGraph(
        np.concatenate([np.arange(n), np.arange(n - 1)]).astype(np.int32),
        np.concatenate([np.arange(n), np.arange(1, n)]).astype(np.int32),
        np.full((n, 7), 0.25, np.float32), n - 1)
    got, want = card.score_unit(fns, unit), cpu.score_unit(fns, unit)
    assert abs(got["unit_score"] - want["unit_score"]) <= 1e-4
    for a, b in zip(got["attribution"], want["attribution"]):
        assert abs(a["score"] - b["score"]) <= 1e-4
    assert card.score_unit(fns, unit) == got | {"level1": card.stats()}


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,variant", [
    (2048, 128, 128, "wgmma"),   # the first ladder bucket's edge linear
    (5120, 128, 384, "wgmma"),   # the megabatch shape's GRU products
    (16768, 128, 384, "wgmma"),  # the largest training bucket's
    (37, 100, 130, "ffma"),      # nothing aligned
    (1, 256, 127, "ffma"),       # one row, odd N
])
def test_int8_kernel_matches_plain_version(cuda, m, k, n, variant):
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    rng = np.random.default_rng(m + n)
    q, scale = tmm.calibrate_int8(rng.normal(size=(k, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    q, scale = torch.from_numpy(q).cuda(), torch.from_numpy(scale).cuda()
    before = tmm.n_launches, tmm.n_variant_launches[variant]
    got = tmm.int8_matmul(x, q, scale)
    again = tmm.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert tmm.n_launches - before[0] == 2
    assert tmm.n_variant_launches[variant] - before[1] == 2
    assert torch.equal(got, again)
    want = tmm.int8_matmul_reference(x, q, scale)
    # float32 sums in another order than cuBLAS's (the tensor cores' over
    # three exact bf16 terms of x, or FFMA over K)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_takes_ffma_for_a_misaligned_view(cuda, dtype):
    """A view whose storage offset leaves its address off a 16-byte
    boundary cannot be described to TMA: the FFMA variant takes it."""
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    gen = torch.Generator().manual_seed(3)
    q, scale = tmm.calibrate_int8(torch.randn(128, 256, generator=gen).cuda())
    dt = getattr(torch, dtype)
    flat = torch.randn(1 + 64 * 128, generator=gen).to(dt).cuda()
    x = flat[1:].view(64, 128)
    before = tmm.n_variant_launches["ffma"]
    got = tmm.int8_matmul(x, q, scale, out_dtype=dt)
    torch.cuda.synchronize()
    assert tmm.n_variant_launches["ffma"] - before == 1
    want = tmm.int8_matmul_reference(x, q, scale, dt)
    limit = 1e-2 if dtype == "bfloat16" else 1e-5
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= limit * top


class _FailingInt8Lib:
    """Stands in for the built library: every launch reports an error."""

    @staticmethod
    def i8_matmul(*args):
        return 700  # cudaErrorIllegalAddress

    i8_matmul_bf16 = i8_matmul_tc = i8_matmul_tc_bf16 = i8_matmul
    i8_matmul_gemv_bf16 = i8_matmul

    @staticmethod
    def i8_error_string(code):
        return b"an illegal memory access was encountered"


@pytest.mark.gpu
def test_int8_launch_failure_propagates_out_of_from_model(cuda, monkeypatch):
    """The int8 gate refuses a poisoned checkpoint only; a failed launch
    raises out of the engine's constructor instead of serving float32."""
    from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.ops import int8_matmul as tmm
    from deepdfa_tpu_torch.serve import ScoringEngine

    cfg = GGNNConfig(hidden_dim=8, n_steps=2, num_output_layers=2,
                     layout="fused")
    keys = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
    monkeypatch.setattr(tmm, "_lib", _FailingInt8Lib())
    with pytest.raises(RuntimeError, match="launch failed"):
        ScoringEngine.from_model(make_model(cfg, 40, device="cuda"), None,
                                 "graph", keys, max_batch=4, device="cuda",
                                 precision="int8")


@pytest.mark.gpu
def test_int8_engine_on_the_card_matches_the_cpu(cuda):
    from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.ops import int8_matmul as tmm
    from deepdfa_tpu_torch.serve import ScoringEngine

    cfg = GGNNConfig(hidden_dim=8, n_steps=2, num_output_layers=2,
                     layout="fused")
    keys = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
    state = make_model(cfg, 40, device="cpu", seed=4).state_dict()
    engines = [ScoringEngine.from_model(make_model(cfg, 40, device=dev),
                                        state, "graph", keys, max_batch=4,
                                        device=dev, precision="int8")
               for dev in ("cuda", "cpu")]
    assert [e.precision for e in engines] == ["int8", "int8"]
    reqs = random_dataset(4, seed=5, input_dim=40, mean_nodes=20)
    before = tmm.n_launches
    got = engines[0].score(reqs, engines[0].buckets[0])
    assert tmm.n_launches - before == 3 * cfg.n_steps
    want = engines[1].score(reqs, engines[1].buckets[0])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _attention_inputs(b, s, h, h_kv, d, dtype, seed):
    """q, k, v on the card and a left-padded pad mask: row 0 unpadded, the
    last row all padding, the others padded by a seeded amount."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dt).cuda()
               for n in (h, h_kv, h_kv))
    mask = torch.ones(b, s, dtype=torch.bool)
    for i in range(1, b):
        pads = s if i == b - 1 else int(torch.randint(1, s, (1,),
                                                      generator=gen))
        mask[i, :pads] = False
    return q, k, v, mask.cuda()


# (b, s, h, h_kv, d, dtype, causal, the variant the shape takes)
ATTENTION_CASES = [
    (2, 256, 4, 4, 128, "bfloat16", True, "wgmma"),   # the 7B head width
    (3, 384, 8, 2, 128, "bfloat16", True, "wgmma"),   # grouped kv heads
    (2, 256, 4, 2, 128, "bfloat16", False, "wgmma"),  # not causal
    (3, 200, 8, 2, 64, "bfloat16", True, "mma"),     # ragged s, grouped
    (2, 128, 2, 1, 32, "bfloat16", False, "mma"),    # not causal
    (2, 200, 2, 2, 128, "bfloat16", True, "mma"),    # s off the wgmma tile
    (2, 128, 4, 2, 16, "float32", True, "ffma"),     # tiny_llama
    (2, 100, 2, 2, 128, "float32", True, "ffma"),    # ragged, FFMA at 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,d,dtype,causal,variant",
                         ATTENTION_CASES)
def test_flash_kernel_matches_plain_version(cuda, b, s, h, h_kv, d, dtype,
                                            causal, variant):
    from deepdfa_tpu_torch.ops import flash_attention as tfa

    q, k, v, mask = _attention_inputs(b, s, h, h_kv, d, dtype, s + d)
    assert tfa.variant(q, k, v) == variant
    for m in (mask, None):
        before = tfa.n_launches, tfa.n_variant_launches[variant]
        with torch.inference_mode():
            got = tfa.flash_attention(q, k, v, m, causal=causal)
            again = tfa.flash_attention(q, k, v, m, causal=causal)
            want = tfa.flash_attention_reference(q, k, v, m, causal=causal)
        torch.cuda.synchronize()
        assert tfa.n_launches - before[0] == 2
        assert tfa.n_variant_launches[variant] - before[1] == 2
        assert got.dtype == q.dtype and torch.equal(got, again)
        # each row over its own largest value: a row that sees one key has
        # outputs of ~4, one that sees hundreds of ~0.1. bf16: P rounded at
        # a running maximum against the row's maximum (the JAX package's
        # 2e-2 bar); float32: sums in other orders
        err = (got.float() - want.float()).abs().amax(dim=-1)
        top = want.float().abs().amax(dim=-1)
        limit = 2e-2 if dtype == "bfloat16" else 1e-5
        assert bool((err <= limit * top).all())


class _FailingFlashLib:
    """Stands in for a built library: every launch reports an error."""

    @staticmethod
    def fa_forward(*args):
        return 1  # cudaErrorInvalidValue

    @staticmethod
    def fa_error_string(code):
        return b"invalid argument"

    fa_forward_tc = fa_backward_dkv = fa_backward_dq = fa_forward
    fa_backward_dkv_tc = fa_backward_dq_tc = fa_forward
    fa_bwd_error_string = fa_error_string


@pytest.mark.gpu
def test_flash_kernel_raises_for_gradients_and_failed_launches(cuda,
                                                                monkeypatch):
    """A gradient through B6 runs B6b; a failed launch of either raises, and
    a head width the kernels are not built for raises before any launch,
    with or without a gradient: nothing falls back to the plain version."""
    from deepdfa_tpu_torch.ops import flash_attention as tfa

    q, k, v, mask = _attention_inputs(1, 128, 2, 2, 64, "bfloat16", 0)
    before = tfa.n_bwd_launches
    tfa.flash_attention(q.requires_grad_(True), k, v, mask).sum().backward()
    assert tfa.n_bwd_launches - before == 2 and q.grad is not None
    bad = torch.zeros(1, 128, 2, 24, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention(bad, bad, bad)
    out = tfa.flash_attention(q, k, v, mask)  # forward on the real library
    monkeypatch.setattr(tfa, "_bwd_lib", _FailingFlashLib())
    with pytest.raises(RuntimeError, match="backward.*launch failed"):
        out.sum().backward()
    monkeypatch.setattr(tfa, "_lib", _FailingFlashLib())
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa.flash_attention(q.detach(), k, v, mask)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa.flash_attention(q, k, v, mask)


def _single_key_rows(mask, s, causal):
    """Rows whose gradient is 0 in exact arithmetic: queries that see one
    key (the softmax of one score does not depend on it), and keys seen
    only by such queries. Both sides return rounding noise there."""
    keep = torch.ones(s, s, dtype=torch.bool, device=mask.device)
    keep = torch.tril(keep) if causal else keep
    seg = mask.int()
    keep = keep[None] & (seg[:, :, None] == seg[:, None, :])  # [b, q, k]
    q_one = keep.sum(-1) == 1
    k_zero = ~(keep & ~q_one[..., None]).any(dim=1)
    return q_one, k_zero


def _grad_row_err(got, want, zero_rows):
    """The largest error of a row (the last axis) over that row's largest
    value; rows in ``zero_rows`` ([b, s]) over the tensor's largest."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    top = want.abs().amax(dim=-1)
    top = torch.where(zero_rows[..., None], want.abs().max(), top)
    return float((err / top.clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,h_kv,d,dtype,causal,variant",
                         ATTENTION_CASES)
def test_flash_backward_kernel_matches_plain_version(cuda, b, s, h, h_kv, d,
                                                     dtype, causal, variant):
    """B6b against ``flash_attention_backward_reference`` on the same
    forward output and logsumexp, each row of dq, dk and dv over that row's
    largest value: bf16 2e-2 (the JAX package's bar for its flash path;
    p and ds rounded to bf16 from float32 values that differ in their last
    bits), float32 1e-5 (sums in other orders); two calls bitwise equal."""
    from deepdfa_tpu_torch.ops import flash_attention as tfa

    q, k, v, mask = _attention_inputs(b, s, h, h_kv, d, dtype, s + d + 1)
    gen = torch.Generator().manual_seed(s)
    do = torch.randn(q.shape, generator=gen).to(q.dtype).cuda()
    limit = 2e-2 if dtype == "bfloat16" else 1e-5
    for m in (mask, None):
        out, lse = tfa.flash_attention_forward(q, k, v, m, causal=causal)
        _, lse_ref = tfa._reference_forward(q, k, v, m, causal)
        assert float((lse - lse_ref).abs().max()) <= 1e-4
        before = tfa.n_bwd_launches, tfa.n_bwd_variant_launches[variant]
        got = tfa.flash_attention_backward(q, k, v, out, do, lse, m,
                                           causal=causal)
        again = tfa.flash_attention_backward(q, k, v, out, do, lse, m,
                                             causal=causal)
        torch.cuda.synchronize()
        assert tfa.n_bwd_launches - before[0] == 4
        assert tfa.n_bwd_variant_launches[variant] - before[1] == 4
        want = tfa.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                      m, causal=causal)
        mm = torch.ones(b, s, dtype=torch.bool, device="cuda") if m is None \
            else m
        q_one, k_zero = _single_key_rows(mm, s, causal)
        for name, x, y, again_x in zip(("dq", "dk", "dv"), got, want, again):
            assert x.dtype == q.dtype and x.shape == y.shape
            assert torch.equal(x, again_x), name
            zero = q_one if name == "dq" else (k_zero if name == "dk"
                                               else torch.zeros_like(k_zero))
            assert _grad_row_err(x, y, zero) <= limit, name


@pytest.mark.gpu
@pytest.mark.parametrize("cotangent", ["sum", "mean", "transposed"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_gradients_for_reduced_and_transposed_cotangents(cuda, dtype,
                                                              cotangent):
    """A loss that reduces the attention output directly (autograd hands
    B6b an expanded cotangent) or reads it transposed: the gradients of the
    kernels' autograd path against ``flash_attention_backward_reference``
    on the same forward and the dense cotangent, per row as above (bf16
    2e-2, float32 1e-5)."""
    from deepdfa_tpu_torch.ops import flash_attention as tfa

    b, s, h, h_kv, d = 2, 256, 4, 2, 64
    q, k, v, mask = _attention_inputs(b, s, h, h_kv, d, dtype, 7)
    gen = torch.Generator().manual_seed(8)
    weight = torch.randn((b, h, s, d), generator=gen).to(q.dtype).cuda()
    loss = {"sum": lambda o: o.sum(), "mean": lambda o: o.mean(),
            "transposed": lambda o: (o.transpose(1, 2) * weight).sum()
            }[cotangent]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    loss(tfa.flash_attention(*leaves, mask)).backward()
    out, lse = tfa.flash_attention_forward(q, k, v, mask)
    probe = out.clone().requires_grad_(True)
    do = torch.autograd.grad(loss(probe), probe)[0].contiguous()
    want = tfa.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                  mask)
    q_one, k_zero = _single_key_rows(mask, s, True)
    limit = 2e-2 if dtype == "bfloat16" else 1e-5
    for name, leaf, y in zip(("dq", "dk", "dv"), leaves, want):
        zero = q_one if name == "dq" else (k_zero if name == "dk"
                                           else torch.zeros_like(k_zero))
        assert _grad_row_err(leaf.grad, y, zero) <= limit, name


@pytest.mark.gpu
def test_lora_gradients_through_flash_on_the_card_match_the_cpu(cuda):
    """One LoRA loss and its adapter gradients on ``tiny_llama(attn_impl=
    "flash")``: B6 and B6b on the card against autograd of the plain
    version on the CPU, float32, ≤ 1e-4 of each gradient's largest value
    (FFMA against the CPU's sums)."""
    from deepdfa_tpu_torch.llm import finetune as tft
    from deepdfa_tpu_torch.llm import llama as tl
    from deepdfa_tpu_torch.llm.lora import freeze_base
    from deepdfa_tpu_torch.ops import flash_attention as tfa

    cfg = tl.tiny_llama(attn_impl="flash", lora_rank=4)
    state = tl.build_llama(cfg, "cpu", seed=5,
                           cls=tl.LlamaForCausalLM).state_dict()
    gen = torch.Generator().manual_seed(2)
    for key in state:
        if key.endswith("lora_b"):
            state[key] = torch.randn(state[key].shape, generator=gen) * 0.05
    ids = torch.randint(3, cfg.vocab_size, (2, 128), generator=gen)
    mask = torch.ones(2, 128, dtype=torch.bool)
    mask[1, :40] = False
    grads = []
    for dev in ("cpu", "cuda"):
        model = tl.build_llama(cfg, dev, seed=None, cls=tl.LlamaForCausalLM)
        model.load_state_dict(state)
        freeze_base(model)
        fb = tfa.n_bwd_launches
        loss = tft.lm_loss(model(ids.to(dev), mask.to(dev)), ids.to(dev),
                           mask.to(dev))
        loss.backward()
        assert tfa.n_bwd_launches - fb == (2 * cfg.num_hidden_layers
                                           if dev == "cuda" else 0)
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.requires_grad})
    assert set(grads[0]) == set(grads[1]) and len(grads[0]) == 4 * \
        cfg.num_hidden_layers
    for name, want in grads[0].items():
        err = float((grads[1][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,out,variant", [
    (1024, 4096, 4096, "bfloat16", "wgmma"),    # the 7B q, k, v, o
    (1024, 4096, 11008, "bfloat16", "wgmma"),   # the 7B gate and up
    (1024, 11008, 4096, "bfloat16", "wgmma"),   # the 7B down
    (1024, 5120, 13824, "bfloat16", "wgmma"),   # the 13B gate and up
    (300, 200, 272, "bfloat16", "wgmma"),       # ragged M and K tiles
    (37, 100, 130, "bfloat16", "ffma"),         # nothing aligned
    (5, 256, 127, "float32", "ffma"),           # float32 output, odd N
])
def test_int8_kernel_with_bf16_activations_matches_plain_version(
        cuda, m, k, n, out, variant):
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    gen = torch.Generator().manual_seed(m + n)
    q, scale = tmm.calibrate_int8((torch.randn(k, n, generator=gen)
                                   * k ** -0.5).cuda())
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
    dt = getattr(torch, out)
    before = tmm.n_launches, tmm.n_variant_launches[variant]
    got = tmm.int8_matmul(x, q, scale, out_dtype=dt)
    again = tmm.int8_matmul(x, q, scale, out_dtype=dt)
    torch.cuda.synchronize()
    assert tmm.n_launches - before[0] == 2 and got.dtype == dt
    assert tmm.n_variant_launches[variant] - before[1] == 2
    assert torch.equal(got, again)
    want = tmm.int8_matmul_reference(x, q, scale, dt)
    top = float(want.float().abs().max())
    # float32 sums in another order; a bf16 output may round one ulp apart
    limit = 1e-2 if out == "bfloat16" else 1e-5
    assert float((got.float() - want.float()).abs().max()) <= limit * top


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(attn_impl="flash"),
                                dict(attn_impl="flash", int8_runtime=True)])
def test_tiny_llama_on_the_card_matches_the_cpu(cuda, kw):
    from deepdfa_tpu_torch.llm import llama as tl
    from deepdfa_tpu_torch.llm.quant import to_int8_runtime_params
    from deepdfa_tpu_torch.ops import flash_attention as tfa
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    cfg = tl.tiny_llama(**kw)
    state = tl.build_llama(tl.tiny_llama(), "cpu", seed=5).state_dict()
    if cfg.int8_runtime:
        state = to_int8_runtime_params(state)
    models = []
    for dev in ("cpu", "cuda"):
        model = tl.build_llama(cfg, dev, seed=None)
        model.load_state_dict(state)
        models.append(model)
    ids = torch.randint(3, cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 128, dtype=torch.bool)
    mask[1, :40] = False
    fa0, i80 = tfa.n_launches, tmm.n_launches
    with torch.inference_mode():
        want = models[0](ids, mask)
        got = models[1](ids.cuda(), mask.cuda()).cpu()
    assert tfa.n_launches - fa0 == cfg.num_hidden_layers
    assert tmm.n_launches - i80 == (7 * cfg.num_hidden_layers
                                    if cfg.int8_runtime else 0)
    # FFMA in the kernels against the CPU's sums, every row
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.gpu
def test_latency_mode_submit_on_the_card_equals_score(cuda):
    """Latency-mode ``submit`` on the fused kernel: uploads and launches
    without a host sync, and its read-back equals the synchronous
    ``score`` bitwise; submits from several threads each read their own
    batch's scores."""
    import threading

    from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.serve import ScoringEngine

    keys = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
    cfg = GGNNConfig(hidden_dim=32, n_steps=5, num_output_layers=3,
                     layout="fused")
    engine = ScoringEngine.from_model(make_model(cfg, 1002, device="cuda"),
                                      None, "graph", keys, max_batch=16,
                                      device="cuda", latency_mode=True)
    engine.warmup()
    bucket = engine.buckets[0]
    groups = [random_dataset(3, seed=s, input_dim=1002, mean_nodes=40)
              for s in range(6)]
    before = tfg.n_launches
    pending = [engine.submit(g, bucket) for g in groups]
    got = [p.result() for p in pending]
    assert tfg.n_launches - before == 6 * tfg.launches_per_call(5)
    engine.latency_mode = False
    want = [engine.score(g, bucket) for g in groups]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    engine.latency_mode = True
    errors = []

    def worker(i):
        try:
            for _ in range(4):
                np.testing.assert_array_equal(
                    engine.submit(groups[i], bucket).result(), want[i])
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


# ---------------------------------------------------------------------------
# the registered ops (ops/custom_ops.py): each one's CUDA implementation
# against its CPU one on the same inputs, counted like a live call


def _op_case(op, rng):
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    if op == "fused_ggnn":
        # the first ladder bucket's shape at width 128, 5 rounds
        args = _problem(rng, 2048, 128, 8192)
        return args + [5], tfg, tfg.launches_per_call(5), 1e-4
    if op == "segment_sum":
        # the pooling's sum of 16,768 node rows into 257 graph slots
        data = torch.from_numpy(
            rng.standard_normal((16768, 256)).astype(np.float32)).cuda()
        ids = torch.from_numpy(
            np.sort(rng.integers(0, 257, 16768)).astype(np.int32)).cuda()
        return [data, ids, 257], None, 0, 1e-5
    q, scale = tmm.calibrate_int8(
        rng.normal(size=(128, 384)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(5120, 128)).astype(np.float32))
    return ([x.cuda(), torch.from_numpy(q).cuda(),
             torch.from_numpy(scale).cuda(), torch.float32], tmm, 1, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fused_ggnn", "segment_sum", "int8_matmul"])
def test_registered_op_on_the_card_matches_its_cpu_implementation(cuda, op):
    from deepdfa_tpu_torch.ops import custom_ops

    fn = getattr(custom_ops, op)
    args, counter, per_call, limit = _op_case(op, np.random.default_rng(7))
    before = counter.n_launches if counter is not None else 0
    with torch.inference_mode():
        got = fn(*args)
        again = fn(*args)
        want = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args])
    torch.cuda.synchronize()
    if counter is not None:
        assert counter.n_launches - before == 2 * per_call
    # no float atomics on the card: two calls are bitwise equal
    assert torch.equal(got, again) and got.device.type == "cuda"
    # float32 sums in another order than the CPU's, over the largest value
    top = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= limit * max(top, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 4096, 11008),
                                   (8, 11008, 4096), (4, 4096, 32016),
                                   (16, 4096, 4096),
                                   (32, 4096, 4096),     # GEMV_MAX_M tokens
                                   (4, 5120, 5120),      # the 13B q, k, v, o
                                   (8, 5120, 13824),     # the 13B gate, up
                                   (16, 13824, 5120),    # the 13B down
                                   (4, 5120, 32016),     # the 13B lm_head
                                   # K % 16 == 8 (the last k16 step half
                                   # masked) and M filling part of a group
                                   # of two (9-16) or four (17-32) tiles
                                   (8, 520, 144), (12, 1032, 400),
                                   (20, 4104, 256)])
def test_int8_kernel_at_decode_shapes_matches_plain_version(cuda, m, k, n):
    """B5 at one token a row: the ``gemv`` variant (K split over the card,
    the splits summed in order through a cluster's shared memory), rows
    past M and lm_head's ragged column tile neither read nor written, two
    calls bitwise equal."""
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    gen = torch.Generator().manual_seed(m + n)
    q, scale = tmm.calibrate_int8((torch.randn(k, n, generator=gen)
                                   * k ** -0.5).cuda())
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
    before = tmm.n_variant_launches["gemv"]
    got = tmm.int8_matmul(x, q, scale, out_dtype=torch.bfloat16)
    again = tmm.int8_matmul(x, q, scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tmm.n_variant_launches["gemv"] - before == 2
    assert torch.equal(got, again)
    want = tmm.int8_matmul_reference(x, q, scale, torch.bfloat16)
    top = float(want.float().abs().max())
    # float32 sums in another order; a bf16 output may round one ulp apart
    assert float((got.float() - want.float()).abs().max()) <= 1e-2 * top


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 4096, 4096), (4, 4096, 32016)])
def test_int8_gemv_replays_from_a_cuda_graph_bitwise(cuda, m, k, n):
    """A gemv call captured in a CUDA graph and replayed three times gives
    the eager call's output bitwise: the split-K sum keeps no state between
    calls (no workspace, no counter)."""
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    gen = torch.Generator().manual_seed(n)
    q, scale = tmm.calibrate_int8((torch.randn(k, n, generator=gen)
                                   * k ** -0.5).cuda())
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
    eager = tmm.int8_matmul(x, q, scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = tmm.n_variant_launches["gemv"]
    with torch.cuda.graph(graph):
        out = tmm.int8_matmul(x, q, scale, out_dtype=torch.bfloat16)
    assert tmm.n_variant_launches["gemv"] - before == 1
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_int8_vjp_on_the_card_sums_bf16_operands_in_float32(cuda, x_dtype):
    """The activation gradient through B5 on the card: bf16 operands,
    float32 sums (``torch.mm(..., out_dtype=float32)``), against the same
    bf16 operands widened to float32 on the CPU."""
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    gen = torch.Generator().manual_seed(5)
    q, scale = tmm.calibrate_int8(torch.randn(256, 384, generator=gen))
    x = torch.randn(64, 256, generator=gen).to(x_dtype)
    g = torch.randn(64, 384, generator=gen).to(x_dtype)
    xc = x.cuda().requires_grad_()
    before = tmm.n_vjp_products
    tmm.int8_matmul(xc, q.cuda(), scale.cuda(), out_dtype=x_dtype).backward(
        g.cuda())
    assert tmm.n_vjp_products - before == 1 and xc.grad.dtype == x_dtype
    want = ((g.float() * scale).to(torch.bfloat16).float()
            @ q.t().to(torch.bfloat16).float()).to(x_dtype)
    top = float(want.float().abs().max())
    # float32 sums in another order (then one bf16 rounding for bf16 x)
    limit = 1e-2 if x_dtype == torch.bfloat16 else 1e-5
    assert float((xc.grad.cpu().float() - want.float()).abs().max()) <= \
        limit * top


@pytest.mark.gpu
def test_greedy_generation_on_the_card_matches_the_cpu(cuda):
    """``generate`` on ``tiny_llama`` (float32, int8 projections on B5):
    the card's tokens are the CPU's, one B5 launch a projection a step."""
    from deepdfa_tpu_torch.llm import llama as tl
    from deepdfa_tpu_torch.llm.generate import GenerateConfig, generate
    from deepdfa_tpu_torch.llm.quant import to_int8_runtime_params
    from deepdfa_tpu_torch.ops import int8_matmul as tmm

    cfg = tl.tiny_llama(int8_runtime=True)
    state = to_int8_runtime_params(tl.build_llama(
        tl.tiny_llama(), "cpu", seed=5, cls=tl.LlamaForCausalLM).state_dict())
    models = []
    for dev in ("cpu", "cuda"):
        model = tl.build_llama(cfg, dev, seed=None, cls=tl.LlamaForCausalLM)
        model.load_state_dict(state)
        models.append(model)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, :5] = False
    g = GenerateConfig(max_new_tokens=8, do_sample=False)
    before = tmm.n_launches
    got = generate(models[1], ids, mask, g)
    assert tmm.n_launches - before == (16 + 8 - 1) * (
        7 * cfg.num_hidden_layers + 1)
    np.testing.assert_array_equal(got, generate(models[0], ids, mask, g))
