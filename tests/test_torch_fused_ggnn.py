"""The port's fused GGNN op (deepdfa_tpu_torch/ops/fused_ggnn.py) against the
JAX package's Pallas kernel, run in interpret mode, and its unrolled XLA
reference, on the same numpy inputs. On the CPU the port's wrapper runs its
plain torch version; the CUDA kernel is held against that version by
tests/test_torch_cuda.py and by ``chip_smoke.py`` on the card.

Tolerance: atol=2e-5, rtol=1e-4 — the matmuls sum 8-200-wide dots in
another order than XLA does; the per-receiver edge sums are in the same
edge-list order on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.ops import fused_ggnn as jfg  # noqa: E402

from deepdfa_tpu_torch.ops import fused_ggnn as tfg  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _problem(rng, n, d, e, scale=0.1, sort=True):
    h0 = rng.standard_normal((n, d)).astype(np.float32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    if sort:
        rcv = np.sort(rcv)
    snd = rng.integers(0, n, e).astype(np.int32)
    w = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return (h0, snd, rcv, w(d, d), w(d), w(d, 3 * d), w(3 * d),
            w(d, 3 * d), w(3 * d))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("n,d,e,steps", [
    (5, 8, 7, 3),       # below every tile
    (37, 96, 90, 4),    # unpadded odd sizes
    (64, 128, 256, 2),  # the serving width
    (130, 200, 1, 2),   # a single edge, width past one column tile
])
def test_matches_jax_interpret_kernel_and_reference(n, d, e, steps):
    args = _problem(np.random.default_rng(n * 1000 + d + e), n, d, e)
    got = tfg.fused_ggnn(*_torch(args), n_steps=steps).numpy()
    kernel = np.asarray(jfg.fused_ggnn(*args, n_steps=steps, interpret=True))
    ref = np.asarray(jfg._unrolled_reference(*args, steps, True))
    assert got.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_n_steps_zero_is_identity():
    args = _problem(np.random.default_rng(0), 12, 16, 20)
    got = tfg.fused_ggnn(*_torch(args), n_steps=0).numpy()
    np.testing.assert_array_equal(got, args[0])
    np.testing.assert_array_equal(
        got, np.asarray(jfg.fused_ggnn(*args, n_steps=0, interpret=True)))


def test_duplicate_edges_each_contribute():
    rng = np.random.default_rng(1)
    h0, _, _, ew, eb, xw, xb, hw, hb = _problem(rng, 10, 16, 0)
    snd = np.array([3, 3, 3, 7], np.int32)
    rcv = np.array([2, 2, 2, 9], np.int32)
    args = (h0, snd, rcv, ew, eb, xw, xb, hw, hb)
    got = tfg.fused_ggnn(*_torch(args), n_steps=2).numpy()
    kernel = np.asarray(jfg.fused_ggnn(*args, n_steps=2, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)


def test_padding_sink_segment_of_batch_np():
    """A real serving batch: thousands of padding edges on the sink node,
    which is the long CSR segment the CUDA kernel walks in order."""
    from deepdfa_tpu_torch.data.graphs import batch_np
    from deepdfa_tpu_torch.data.synthetic import random_dataset

    b = batch_np(random_dataset(3, seed=4, input_dim=40, mean_nodes=10),
                 4, 128, 512)
    rng = np.random.default_rng(5)
    args = list(_problem(rng, 128, 32, 0))
    args[1], args[2] = b.senders, b.receivers
    got = tfg.fused_ggnn(*_torch(args), n_steps=3).numpy()
    ref = np.asarray(jfg._unrolled_reference(*args, 3, True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_unsorted_edges_match_reference():
    """A hand-built edge list, sorted stably by receiver as the op requires,
    gives what the JAX reference gives on the unsorted list."""
    args = list(_problem(np.random.default_rng(2), 30, 24, 70, sort=False))
    ref = np.asarray(jfg._unrolled_reference(*args, 2, False))
    order = np.argsort(args[2], kind="stable")
    args[1], args[2] = args[1][order], args[2][order]
    got = tfg.fused_ggnn(*_torch(args), n_steps=2).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d,dp", [(50, 52), (7, 8), (8, 12)])
def test_width_padding_keeps_the_function(d, dp):
    """The CUDA path pads a width to a multiple of 4 with zero columns and
    zero weight rows per r|z|n block: the padded rounds, cut back to ``d``
    columns, equal the unpadded ones, and the padded columns stay zero."""
    args = _torch(_problem(np.random.default_rng(d), 23, d, 60))
    want = tfg.fused_ggnn_reference(*args, n_steps=3)
    h0, snd, rcv, *w = args
    padded = tfg._pad_width(*w, d, dp)
    got = tfg.fused_ggnn_reference(torch.nn.functional.pad(h0, (0, dp - d)),
                                   snd, rcv, *padded, n_steps=3)
    np.testing.assert_allclose(got[:, :d].numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)
    assert not got[:, d:].any()


def test_cpu_path_never_counts_kernel_launches():
    before = tfg.n_launches
    tfg.fused_ggnn(*_torch(_problem(np.random.default_rng(3), 9, 8, 12)),
                   n_steps=2)
    assert tfg.n_launches == before
    assert tfg.launches_per_call(5) == 11 and tfg.launches_per_call(0) == 0


def test_rejects_other_devices():
    args = _torch(_problem(np.random.default_rng(3), 9, 8, 12))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfg.fused_ggnn(*[a.to("meta") for a in args], n_steps=1)
