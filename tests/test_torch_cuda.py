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


@pytest.mark.gpu
def test_gradients_are_refused(cuda):
    args = _problem(np.random.default_rng(8), 20, 32, 40)
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfg.fused_ggnn(*args, n_steps=1)
