"""The port's segment ops (deepdfa_tpu_torch/ops/segment.py) against
``jax.ops`` and the JAX package's ``segment_softmax``, on sorted and unsorted
ids, including the three masked-softmax rules: masked rows weigh exactly 0,
a padding-only segment's max becomes 0, a zero denominator becomes 1.

Tolerance: sums and maxes are exact on the CPU (``index_add_`` adds in index
order, as XLA's CPU scatter does); the softmax is held to atol=2e-5,
rtol=1e-4 (exp and divide may round differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.ops import segment as jseg  # noqa: E402

from deepdfa_tpu_torch.ops import segment as tseg  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
N_SEG = 7


def _ids(rng, n, sort):
    ids = rng.integers(0, N_SEG - 1, n).astype(np.int32)  # last segment empty
    return np.sort(ids) if sort else ids


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("trailing", [(), (5,)])
def test_segment_sum_and_max_match_jax(sort, trailing):
    rng = np.random.default_rng(len(trailing) * 2 + sort)
    ids = _ids(rng, 40, sort)
    data = rng.standard_normal((40, *trailing)).astype(np.float32)
    t_ids, t_data = torch.from_numpy(ids), torch.from_numpy(data)
    np.testing.assert_array_equal(
        tseg.segment_sum(t_data, t_ids, N_SEG).numpy(),
        np.asarray(jax.ops.segment_sum(data, ids, num_segments=N_SEG)))
    np.testing.assert_array_equal(
        tseg.segment_max(t_data, t_ids, N_SEG).numpy(),
        np.asarray(jax.ops.segment_max(data, ids, num_segments=N_SEG)))


def test_gather_matches_take():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((9, 3)).astype(np.float32)
    idx = rng.integers(0, 9, 20).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.gather(torch.from_numpy(vals), torch.from_numpy(idx)).numpy(),
        np.asarray(jseg.gather(jnp.asarray(vals), jnp.asarray(idx))))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_softmax_matches_jax(sort, masked):
    rng = np.random.default_rng(10 + 2 * sort + masked)
    ids = _ids(rng, 50, sort)
    logits = (rng.standard_normal(50) * 3).astype(np.float32)
    mask = rng.random(50) < 0.7 if masked else None
    got = tseg.segment_softmax(
        torch.from_numpy(logits), torch.from_numpy(ids), N_SEG,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    want = np.asarray(jseg.segment_softmax(
        jnp.asarray(logits), jnp.asarray(ids), N_SEG,
        mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.all(np.isfinite(got))


def test_masked_softmax_rules():
    # segment 0: two real rows and a masked one; segment 1: masked rows only
    # (its max would be -inf); segment 2: empty (denominator 0)
    ids = np.array([0, 0, 0, 1, 1], np.int32)
    logits = np.array([1.0, 2.0, 50.0, 3.0, 4.0], np.float32)
    mask = np.array([True, True, False, False, False])
    got = tseg.segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids),
                               3, mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jseg.segment_softmax(jnp.asarray(logits),
                                           jnp.asarray(ids), 3,
                                           mask=jnp.asarray(mask)))
    assert got[2] == 0.0 and got[3] == 0.0 and got[4] == 0.0
    np.testing.assert_allclose(got[:2].sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    maxes = tseg.segment_max(
        torch.where(torch.from_numpy(mask), torch.from_numpy(logits),
                    torch.tensor(float("-inf"))),
        torch.from_numpy(ids), 3).numpy()
    assert maxes[1] == -np.inf and maxes[2] == -np.inf


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("trailing", [(), (5,)])
def test_ordered_reductions_of_the_card_equal_index_add(sort, trailing):
    """The CUDA path's reductions (stable sort, then ``segment_reduce`` over
    contiguous ranges), run here on CPU tensors: the sum adds each
    segment's rows in index order, so it equals ``index_add_`` bit for bit,
    and the gather's backward equals ``index_select``'s."""
    rng = np.random.default_rng(7 + len(trailing))
    ids = torch.from_numpy(_ids(rng, 40, sort))
    data = torch.from_numpy(rng.standard_normal((40,) + trailing)
                            .astype(np.float32))
    want = torch.zeros((N_SEG,) + trailing).index_add_(0, ids, data)
    assert torch.equal(tseg._ordered_segment_sum(data, ids, N_SEG), want)
    values = torch.from_numpy(rng.standard_normal((N_SEG,) + trailing)
                              .astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((40,) + trailing)
                         .astype(np.float32))
    (got,) = torch.autograd.grad(tseg._Gather.apply(values, ids), values, g)
    (ref,) = torch.autograd.grad(values.index_select(0, ids), values, g)
    assert torch.equal(got, ref)
