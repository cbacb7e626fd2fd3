"""The port's dataflow experiment (``python -m
deepdfa_tpu_torch.dataflow_experiment``) against ``scripts/
dataflow_experiment.py``, on the CPU.

Both preprocess entries build ``demo_hard`` (40 functions, solver labels)
in their own ``DEEPDFA_STORAGE`` trees, byte for byte alike; then:

- ``feature_lr_baseline`` equals the JAX script's bitwise (numpy over the
  same shards; the confusion counts take float32 probabilities in both);
- ``grad_norms_per_step`` on one validation batch of the golden GGNN
  (segment layout), the JAX parameters carried across by
  ``bridge.flax_to_torch``, within 1e-5 relative of ``jax.grad`` of the
  script's ``loss_of_taps``;
- the union-pretrain warm start leaves the head and pooling keys fresh and
  the encoder keys equal to the donor's, and the frozen run leaves the
  encoder bitwise unchanged while the head moves;
- ``main`` at n 40, 2 epochs prints the JAX script's keys, its baseline
  numbers equal.

The sweeps' keys are ``tests/test_torch_dataflow_sweeps.py``.
"""

import contextlib
import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch import dataflow_experiment as exp  # noqa: E402
from deepdfa_tpu_torch.config import ExperimentConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import to_device  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.train import fit as tfit  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import is_head_key  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N = 40
RTOL = 1e-5
HARD = ["--dataset", "demo_hard", "--n", str(N), "--seed", "0",
        "--dataflow-labels", "--overwrite"]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jexp = _load_script("dataflow_experiment")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits (six test workers
    with a thread per core each oversubscribe the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _storage(root: Path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        yield


def _tree_digest(d: Path) -> dict[str, str]:
    """Every file's digest but the feature-hash table's (the JAX script
    writes ``hashes.parquet`` through pandas, the port ``hashes.csv.gz``;
    ``tests/test_torch_corpus.py`` holds their rows equal)."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.iterdir())
            if p.is_file() and not p.name.startswith("hashes.")}


@pytest.fixture(scope="module")
def hard(tmp_path_factory):
    """``demo_hard`` built by both preprocess entries, one storage each."""
    root = tmp_path_factory.mktemp("dataflow_experiment")
    jpre = _load_script("preprocess")
    with _storage(root / "jax"):
        jsum = jpre.main(HARD + ["--workers", "1"])
    with _storage(root / "port"):
        tsum = preprocess.main(HARD + ["--workers", "2"])
    assert jsum["graphs"] == tsum["graphs"] == N
    return root


def test_both_entries_build_the_same_shards(hard):
    shards = Path("processed") / "demo_hard" / "shards"
    assert _tree_digest(hard / "jax" / shards) == \
        _tree_digest(hard / "port" / shards)


def test_feature_lr_baseline_equals_the_jax_script_bitwise(hard):
    with _storage(hard / "jax"):
        want = jexp.feature_lr_baseline(seed=0)
    with _storage(hard / "port"):
        got = exp.feature_lr_baseline(seed=0)
    assert got == want
    assert set(got) == {"feature_lr_f1", "feature_lr_acc",
                        "feature_lr_train_acc"}


def test_grad_norms_per_step_equal_jax_grad_of_the_taps(hard):
    """The script's ``loss_of_taps`` (graph-label BCE of the golden GGNN
    with ``n_steps`` zero taps) differentiated by ``jax.grad``, against
    ``torch.autograd.grad`` of the same loss on the same parameters."""
    jcfg = JExperimentConfig()
    jcfg = jexp._hard_cfg(jcfg)
    with _storage(hard / "jax"):
        jcorpus = jcli.load_corpus(jcfg)
    jbatcher = jcli._batcher(jcfg, jcorpus["train"] + jcorpus["val"]
                             + jcorpus["test"])
    jb = jax.tree.map(jnp.asarray,
                      next(jcli._batch_stream(jbatcher, jcorpus["val"])))
    jmodel = JGGNN(cfg=jcfg.model, input_dim=jcfg.input_dim)
    params = jmodel.init(jax.random.key(0), jb)["params"]
    lab = jloop.graph_labels(jb)
    w = jb.graph_mask.astype(jnp.float32)
    width = jcfg.model.hidden_dim * 4  # concat_all_absdf: 4 subkeys
    taps0 = tuple(jnp.zeros((jb.node_feats["_ABS_DATAFLOW"].shape[0], width),
                            jnp.float32)
                  for _ in range(jcfg.model.n_steps))

    def loss_of_taps(taps):
        logits = jmodel.apply({"params": params}, jb, taps=taps)
        return jloop.bce_with_logits(logits, lab.astype(jnp.float32), w, None)

    want = [float(jnp.linalg.norm(t)) for t in jax.grad(loss_of_taps)(taps0)]

    cfg = exp._hard_cfg(ExperimentConfig())
    with _storage(hard / "port"):
        corpus = tfit.load_corpus(cfg)
    batcher = tfit._batcher(cfg, corpus["train"] + corpus["val"]
                            + corpus["test"])
    batch = next(iter(tfit._batch_stream(batcher, corpus["val"])))
    np.testing.assert_array_equal(batch.senders, np.asarray(jb.senders))
    np.testing.assert_array_equal(batch.graph_mask, np.asarray(jb.graph_mask))
    model = make_model(cfg.model, cfg.input_dim, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg.model, cfg.input_dim))
    got = exp.grad_norms_per_step(model, to_device(batch, "cpu"), cfg)
    assert len(got) == cfg.model.n_steps == 5
    assert all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_union_pretrain_warm_start_and_frozen_encoder(hard):
    """The warm start lays the donor's encoder over a fresh graph model
    (head and pooling keys keep the fresh values); with the encoder
    frozen, training moves the head only."""
    ds = "demo_order2"
    with _storage(hard / "port"):
        preprocess.main(["--dataset", ds, "--n", str(N), "--seed", "0",
                         "--dataflow-labels", "--overwrite", "--workers",
                         "2"])
        common = dict(device="cpu", aggregation="union_relu", n_steps=5)
        _, donor = exp._train_with_curve(
            ds, 1, label_style="dataflow_solution_out", probe_grads=False,
            return_params=True, **common)
        _, fresh = exp._train_with_curve(ds, 0, return_params=True, **common)
        _, warm = exp._train_with_curve(ds, 0, warm_start=donor,
                                        return_params=True, **common)
        frozen_run, frozen = exp._train_with_curve(
            ds, 2, warm_start=donor, freeze_encoder=True,
            return_params=True, **common)
    head = {k for k in fresh if is_head_key(k)}
    encoder = set(fresh) - head
    assert head and encoder and encoder <= set(donor)
    for k in encoder:
        assert torch.equal(warm[k], donor[k]), k
        assert torch.equal(frozen[k], donor[k]), k
    for k in head:
        assert torch.equal(warm[k], fresh[k]), k
    assert any(not torch.equal(frozen[k], fresh[k]) for k in head)
    assert len(frozen_run["curve_tail"]) == 2
    for trace in frozen_run["grad_norm_per_step"].values():
        assert len(trace) == 5 and all(np.isfinite(trace))


def test_main_prints_the_jax_script_keys(hard, capsys):
    argv = ["--n", str(N), "--epochs", "2"]
    with _storage(hard / "jax"):
        want = jexp.main(argv + ["--out", str(hard / "jax_runs")])
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with _storage(hard / "port"):
        got = exp.main(argv + ["--out", str(hard / "port_runs"),
                               "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jline == want and line == got
    assert list(got) == list(want)
    for k in ("feature_lr_f1", "feature_lr_acc", "feature_lr_train_acc", "n"):
        assert got[k] == want[k], k
    for k, v in got.items():
        assert np.isfinite(v), k
