"""The port's fused GGNN gradients (the ``torch.autograd.Function`` in
deepdfa_tpu_torch/ops/fused_ggnn.py) against the JAX package's Pallas
training kernel, run in interpret mode, on the same numpy inputs. On the CPU
the Function's backward is ``fused_ggnn_backward_reference``; the CUDA
backward kernel is held against that version by tests/test_torch_cuda.py and
by ``chip_smoke.py`` on the card. Also: the ``bwd_kernel`` option, the width
padding of the CUDA path, and a JAX-package config with ``bwd_kernel``
building the port's model.

Tolerance: atol=rtol=1e-4, as tests/test_fused_train.py holds the JAX
package's two backward tiers: the products sum in another order than XLA's,
over three to five reverse rounds.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.ops import fused_ggnn as jfg  # noqa: E402

from deepdfa_tpu_torch.config import GGNNConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.ops import fused_ggnn as tfg  # noqa: E402

ATOL = RTOL = 1e-4
NAMES = ("h0", "ew", "eb", "xw", "xb", "hw", "hb")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _problem(rng, n, d, e, scale=0.1):
    h0 = rng.standard_normal((n, d)).astype(np.float32)
    rcv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    snd = rng.integers(0, n, e).astype(np.int32)
    w = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return (h0, snd, rcv, w(d, d), w(d), w(d, 3 * d), w(3 * d),
            w(d, 3 * d), w(3 * d))


def _port_grads(args, g, n_steps, bwd_kernel="auto"):
    """Gradients of ``sum(out * g)`` with respect to h0 and the six weights,
    through the port's public op and its autograd Function."""
    t = [torch.from_numpy(a) for a in args]
    leaves = [t[i].requires_grad_(True) for i in (0, 3, 4, 5, 6, 7, 8)]
    out = tfg.fused_ggnn(leaves[0], t[1], t[2], *leaves[1:], n_steps=n_steps,
                         bwd_kernel=bwd_kernel)
    return [x.numpy() for x in torch.autograd.grad(out, leaves,
                                                   torch.from_numpy(g))]


def _autograd_of_reference(args, g, n_steps):
    t = [torch.from_numpy(a) for a in args]
    leaves = [t[i].requires_grad_(True) for i in (0, 3, 4, 5, 6, 7, 8)]
    out = tfg.fused_ggnn_reference(leaves[0], t[1], t[2], *leaves[1:],
                                   n_steps=n_steps)
    # with no rounds the weights take no part: their gradients are zeros
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g),
                                allow_unused=True, materialize_grads=True)
    return [x.numpy() for x in grads]


@pytest.mark.parametrize("n,d,e", [
    (8, 8, 16),       # below every tile minimum
    (37, 24, 90),     # unaligned shapes
    (64, 128, 256),   # the golden conv width
    (64, 224, 256),   # the dataflow families' width
])
def test_grads_match_jax_pallas_training_kernel(n, d, e):
    rng = np.random.default_rng(n * 77 + d + e)
    args = _problem(rng, n, d, e)
    g = rng.standard_normal((n, d)).astype(np.float32)
    snd, rcv = args[1], args[2]

    def loss(h0, ew, eb, xw, xb, hw, hb):
        out = jfg.fused_ggnn(h0, snd, rcv, ew, eb, xw, xb, hw, hb, n_steps=3,
                             interpret=True, bwd_kernel="pallas")
        return jnp.sum(out * g)

    diff = tuple(args[i] for i in (0, 3, 4, 5, 6, 7, 8))
    want = jax.grad(loss, argnums=tuple(range(7)))(*diff)
    got = _port_grads(args, g, 3)
    auto = _autograd_of_reference(args, g, 3)
    for name, a, b, c in zip(NAMES, got, want, auto):
        assert a.shape == np.shape(b) and a.dtype == np.float32, name
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(a, c, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("n_steps,e", [(0, 40), (2, 0), (5, 1)])
def test_edge_cases_match_autograd(n_steps, e):
    """No rounds (dL/dh0 is g, every weight gradient is zero), no edges, one
    edge over five rounds."""
    rng = np.random.default_rng(n_steps * 10 + e)
    args = _problem(rng, 20, 16, e)
    g = rng.standard_normal((20, 16)).astype(np.float32)
    got = _port_grads(args, g, n_steps)
    want = _autograd_of_reference(args, g, n_steps)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)
    if n_steps == 0:
        np.testing.assert_array_equal(got[0], g)
        assert not any(x.any() for x in got[1:])


@pytest.mark.parametrize("d,dp", [(50, 52), (7, 8)])
def test_width_padding_keeps_the_gradients(d, dp):
    """The CUDA path pads a width to a multiple of 4 with zero columns and
    zero weight rows per r|z|n block: the padded backward, cut back with
    ``_unpad_grads``, equals the unpadded one, and no gradient leaks into the
    padded columns of dL/dh0."""
    rng = np.random.default_rng(d)
    args = [torch.from_numpy(a) for a in _problem(rng, 23, d, 60)]
    g = torch.from_numpy(rng.standard_normal((23, d)).astype(np.float32))
    want = tfg.fused_ggnn_backward_reference(*args, g, n_steps=3)
    h0, snd, rcv, *w = args
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    got = tfg.fused_ggnn_backward_reference(pad(h0), snd, rcv,
                                            *tfg._pad_width(*w, d, dp),
                                            pad(g), n_steps=3)
    assert not got[0][:, d:].any()
    cut = (got[0][:, :d],) + tfg._unpad_grads(*got[1:], d, dp)
    for name, a, b in zip(NAMES, cut, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_bwd_kernel_values():
    """Every valid value runs the plain backward on the CPU, with the same
    gradients; any other value raises naming the option."""
    rng = np.random.default_rng(9)
    args = _problem(rng, 12, 8, 30)
    g = rng.standard_normal((12, 8)).astype(np.float32)
    base = _port_grads(args, g, 2, "auto")
    for value in ("pallas", "xla"):
        for a, b in zip(_port_grads(args, g, 2, value), base):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="bwd_kernel"):
        _port_grads(args, g, 2, "mosaic")
    assert tfg.BWD_KERNELS == ("auto", "pallas", "xla")
    before = tfg.n_bwd_launches
    _port_grads(args, g, 2)
    assert tfg.n_bwd_launches == before  # the CPU path launches nothing
    # three launches a reverse round on the tensor-core variant, six on ffma
    assert tfg.bwd_launches_per_call(5) == 17
    assert tfg.bwd_launches_per_call(5, "ffma") == 32
    assert tfg.bwd_launches_per_call(0) == 0


def test_jax_config_with_bwd_kernel_builds_the_port_model(tmp_path):
    """A JAX-package model config that sets ``bwd_kernel`` loads into the
    port's config and builds its fused model, which passes the option on."""
    jcfg = JCfg(hidden_dim=8, n_steps=3, num_output_layers=2, layout="fused",
                bwd_kernel="pallas")
    fields = dataclasses.asdict(jcfg)
    cfg = GGNNConfig(**fields)
    assert cfg.bwd_kernel == "pallas"
    path = tmp_path / "ggnn.json"
    path.write_text(json.dumps({"model": fields}))
    loaded = load_config(path)
    assert loaded.model == cfg
    model = make_model(loaded.model, loaded.input_dim, device="cpu")
    assert model.ggnn.bwd_kernel == "pallas"
