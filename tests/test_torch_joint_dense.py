"""The dense graph layout under the fusion head, and ``train_joint
--predict-source``, against the JAX package on the CPU.

- ``GraphJoin(layout="dense")``: the per-graph budget (the store's 99th
  percentile, capped by ``max_nodes``), the ``DenseBatch`` of a text batch
  byte for byte the JAX join's, missing and oversize graphs masked and
  counted;
- ``FusionModel`` with a dense encoder on that batch against the JAX
  ``FusionModel`` on the parameters ``bridge.fusion_flax_to_torch``
  carries, and against the port's own segment-layout fusion of the same
  parameters; the JAX module's layout-mismatch ``TypeError`` both ways;
- ``python -m deepdfa_tpu_torch.train_joint --predict-source`` over the
  realworld fixtures after a 1-epoch run, against ``scripts/train_joint.py``
  doing the same: the same JSON keys, rows and error rows (their
  probabilities differ: the weights come from different generators).

Tolerances: batches exact; logits atol = rtol = 1e-5 (float32 sums in
other orders, as ``tests/test_torch_joint.py``); dense against segment
fusion 1e-4 (``tests/test_ggnn_dense.py``'s bar).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess, train_joint  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import Graph, to_device  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import fusion as tfusion  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REALWORLD = REPO / "tests" / "fixtures" / "realworld"
INPUT_DIM = 52
HIDDEN = 16
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stores(n=12, seed=3):
    """A JAX and a port graph store of the same seeded graphs, ids 0..n-1,
    one of them far larger than the rest (over the p99 budget)."""
    jg = jdataset(n, seed=seed, input_dim=INPUT_DIM, mean_nodes=10)
    big = jdataset(1, seed=seed + 1, input_dim=INPUT_DIM, mean_nodes=90)[0]
    jg[5] = big
    jstore = {i: g for i, g in enumerate(jg)}
    tstore = {i: Graph(g.senders, g.receivers, dict(g.node_feats), i)
              for i, g in enumerate(jg)}
    return jstore, tstore


def _text_batch(ids, mask):
    """A text batch (ids only matter for the join) for both packages."""
    b = len(ids)
    args = (np.zeros((b, 8), np.int32), np.zeros(b, np.int32),
            np.asarray(ids, np.int64), np.asarray(mask, bool),
            np.ones((b, 8), bool))
    return tds.TextBatch(*args), jds.TextBatch(*args)


@pytest.mark.parametrize("max_nodes", [4096, 16])
def test_dense_graph_join_is_the_jax_join(max_nodes):
    jstore, tstore = _stores()
    tjoin = tds.GraphJoin(graphs=tstore, max_nodes=max_nodes, layout="dense")
    jjoin = jds.GraphJoin(graphs=jstore, max_nodes=max_nodes, layout="dense")
    # 5 is the outlier, 40 is missing, the last row is padding
    tb, jb = _text_batch([0, 5, 40, 7, 2, -1], [1, 1, 1, 1, 1, 0])
    got, want = tjoin.join(tb), jjoin.join(jb)
    assert type(got.graphs).__name__ == "DenseBatch"
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.graphs.node_feats.keys() == want.graphs.node_feats.keys()
    for k in got.graphs.node_feats:
        np.testing.assert_array_equal(got.graphs.node_feats[k],
                                      want.graphs.node_feats[k])
    for name in ("adj", "node_mask", "graph_mask"):
        a, b = getattr(got.graphs, name), getattr(want.graphs, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (tjoin.num_missing, tjoin.num_oversize) == \
        (jjoin.num_missing, jjoin.num_oversize)
    assert tjoin.num_missing == 1 and tjoin.num_oversize >= 1
    assert not got.mask[1] and not got.mask[2] and got.mask[0]


def _fusion_pair(layout="dense", seed=1):
    """(JAX fusion module, its params, the port's fusion in ``layout``
    with those params)."""
    jcfg = JCfg(**SMALL, layout="dense")
    jfus = jfusion.FusionModel(gnn_cfg=jcfg, input_dim=INPUT_DIM,
                               llm_hidden_size=HIDDEN, dropout_rate=0.1)
    jstore, _ = _stores()
    jjoin = jds.GraphJoin(graphs=jstore, layout="dense")
    graphs = jjoin.join(_text_batch([0, 1], [1, 1])[1]).graphs
    params = jfus.init({"params": jax.random.key(seed),
                        "dropout": jax.random.key(2)},
                       np.zeros((2, 8, HIDDEN), np.float32),
                       jax.tree.map(jnp.asarray, graphs), deterministic=True,
                       token_mask=np.ones((2, 8), bool))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = GGNNConfig(**SMALL, layout=layout)
    fus = tfusion.build_fusion(cfg, INPUT_DIM, HIDDEN, dropout_rate=0.1,
                               device="cpu")
    fus.load_state_dict(bridge.fusion_flax_to_torch(params, cfg, INPUT_DIM))
    return jfus, params, fus


def test_dense_fusion_logits_equal_jax_and_the_segment_fusion():
    jstore, tstore = _stores()
    jfus, params, fus = _fusion_pair()
    _, _, seg_fus = _fusion_pair("segment")
    ids, mask = [0, 5, 3, 7], [1, 1, 1, 0]
    tb, jb = _text_batch(ids, mask)
    tjoin = tds.GraphJoin(graphs=tstore, layout="dense")
    jjoin = jds.GraphJoin(graphs=jstore, layout="dense")
    got_b, want_b = tjoin.join(tb), jjoin.join(jb)
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(4, 8, HIDDEN)).astype(np.float32)
    tmask = np.ones((4, 8), bool)
    tmask[2, :3] = False
    want = np.asarray(jfus.apply({"params": params}, jnp.asarray(hidden),
                                 jax.tree.map(jnp.asarray, want_b.graphs),
                                 deterministic=True, token_mask=tmask))
    with torch.inference_mode():
        got = fus(torch.from_numpy(hidden),
                  to_device(got_b.graphs, "cpu"),
                  token_mask=torch.from_numpy(tmask)).numpy()
        seg_join = tds.GraphJoin(graphs=tstore)
        seg = seg_fus(torch.from_numpy(hidden),
                      to_device(seg_join.join(tb).graphs, "cpu"),
                      token_mask=torch.from_numpy(tmask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # rows whose graph both joins hold (the outlier is a dense placeholder)
    keep = got_b.mask
    np.testing.assert_allclose(got[keep], seg[keep], atol=1e-4, rtol=1e-4)


def test_a_layout_mismatch_raises_the_jax_error():
    _, tstore = _stores()
    tb, _ = _text_batch([0, 1], [1, 1])
    hidden = torch.zeros(2, 8, HIDDEN)
    dense_batch = tds.GraphJoin(graphs=tstore, layout="dense").join(tb)
    seg_batch = tds.GraphJoin(graphs=tstore).join(tb)
    _, _, dense_fus = _fusion_pair()
    _, _, seg_fus = _fusion_pair("segment")
    with pytest.raises(TypeError, match="segment-layout graph batch"):
        dense_fus(hidden, to_device(seg_batch.graphs, "cpu"))
    with pytest.raises(TypeError, match="dense-layout graph batch"):
        seg_fus(hidden, to_device(dense_batch.graphs, "cpu"))


# ------------------------------------------------------- predict-source


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    """The demo sample shards (60 functions) as ``DEEPDFA_STORAGE``."""
    root = tmp_path_factory.mktemp("joint_dense")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        summary = preprocess.main(["--dataset", "demo", "--n", "120",
                                   "--sample", "--workers", "1"])
        assert summary["graphs"] == 60
        yield root


def _rows(out: dict) -> list:
    """The scan's rows less their probabilities."""
    return [{k: v for k, v in r.items() if k != "vulnerable_probability"}
            for r in out["results"]]


def test_predict_source_prints_the_jax_scripts_keys(storage, tmp_path):
    base = ["--dataset", "demo", "--sample"]
    train = base + ["--do_train", "--epochs", "1", "--block_size", "64"]
    scan = base + ["--block_size", "64", "--predict-source", str(REALWORLD),
                   "--predict-source", str(tmp_path / "empty")]
    (tmp_path / "empty").mkdir()
    jax_script = _load_script("train_joint")
    jrun, trun = tmp_path / "jax", tmp_path / "port"
    jax_script.main(train + ["--output_dir", str(jrun)])
    train_joint.main(train + ["--output_dir", str(trun), "--device", "cpu"])
    want = jax_script.main(scan + ["--output_dir", str(jrun)])
    got = train_joint.main(scan + ["--output_dir", str(trun), "--device",
                                   "cpu"])
    assert sorted(got) == sorted(want) == sorted(
        ["results", "n_scored", "n_errors", "checkpoint", "run_dir"])
    assert (got["n_scored"], got["n_errors"], got["checkpoint"]) == \
        (want["n_scored"], want["n_errors"], want["checkpoint"])
    assert got["n_scored"] > 0 and got["n_errors"] == 1
    assert _rows(got) == _rows(want)
    probs = [r["vulnerable_probability"] for r in got["results"]
             if "vulnerable_probability" in r]
    assert len(probs) == got["n_scored"] and all(0 <= p <= 1 for p in probs)
    assert (trun / "predictions.json").is_file()
    with pytest.raises(SystemExit):
        train_joint.main(scan + ["--do_train", "--output_dir", str(trun)])
    with pytest.raises(SystemExit):
        train_joint.main(base + ["--predict-source", str(REALWORLD)])


def test_predict_source_needs_an_epoch_checkpoint(storage, tmp_path):
    with pytest.raises(SystemExit, match="epoch_"):
        train_joint.main(["--dataset", "demo", "--sample", "--output_dir",
                          str(tmp_path), "--predict-source", str(REALWORLD),
                          "--device", "cpu"])


def test_dense_graph_join_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="unknown layout"):
        tds.GraphJoin(graphs={}, layout="ragged")
    _, tstore = _stores()
    join = tds.GraphJoin(graphs=tstore, max_nodes=8, layout="dense")
    tb, _ = _text_batch([0], [1])
    assert join.join(tb).graphs.nodes_per_graph == 8
    assert dataclasses.replace(join).layout == "dense"
