"""The port's LLM entry points (``python -m deepdfa_tpu_torch.finetune_llm``,
``.train_joint``, ``.performance_evaluation``) against the JAX package's
scripts, on the CPU, through their ``main()``.

Both packages run their demo defaults (the tiny seeded models and the hash
tokenizer over the generated demo corpus) on shards the port's preprocess
builds into a temporary ``DEEPDFA_STORAGE`` (byte for byte the JAX
preprocess's, ``tests/test_torch_dataflow_experiment.py``); the port gets
``--device cpu``. Their weights come from different generators, so the
check is the JSON they print: the same keys at every level, and equal
values where no weight enters (example counts, the graded share of the
self-instruct tokens, the splits). ``--preset linevul_fusion`` runs at
CodeBERT-base width with a short block.
"""

import contextlib
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu_torch import finetune_llm  # noqa: E402
from deepdfa_tpu_torch import performance_evaluation  # noqa: E402
from deepdfa_tpu_torch import preprocess, train_joint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (six test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _storage(root: Path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        yield


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    """A storage root holding the demo sample shards (60 functions)."""
    root = tmp_path_factory.mktemp("llm_entry")
    with _storage(root):
        summary = preprocess.main(["--dataset", "demo", "--n", "120",
                                   "--sample", "--workers", "1"])
    assert summary["graphs"] == 60
    return root


def _keys(d: dict) -> list:
    return sorted(d)


def test_finetune_llm_prints_the_jax_scripts_keys(storage, tmp_path):
    argv = ["--dataset", "demo", "--sample", "--epochs", "1"]
    with _storage(storage):
        want = _load_script("finetune_llm").main(
            argv + ["--output_dir", str(tmp_path / "jax")])
        got = finetune_llm.main(
            argv + ["--output_dir", str(tmp_path / "port")] + CPU)
    assert _keys(got) == _keys(want)
    for key in ("preset", "dataset", "n_examples", "block_size", "lora_rank",
                "frac_tokens_graded"):
        assert got[key] == want[key], key
    assert len(got["epoch_losses"]) == 1 and got["epoch_losses"][0] > 0
    assert (Path(got["adapters"]) / "state.pt").is_file()


def test_demo_rows_carry_the_jax_scripts_explanations():
    jdf = _load_script("finetune_llm")._demo_frame(40)
    rows = finetune_llm.demo_rows(40)
    assert [r["cwe"] for r in rows] == jdf.cwe.tolist()
    assert [r["message"] for r in rows] == jdf.message.tolist()
    assert any(r["message"] for r in rows)


@pytest.fixture(scope="module")
def jax_roberta_run(storage, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_roberta")
    with _storage(storage):
        return _load_script("train_joint").main(
            ["--dataset", "demo", "--sample", "--encoder", "roberta",
             "--do_train", "--do_test", "--epochs", "1", "--output_dir",
             str(out)])


def _same_shape(got: dict, want: dict, same_steps: bool = True) -> None:
    """The same keys, the same kinds of history entry (in the same order
    when both ran the same steps) and the same split counts."""
    assert _keys(got) == _keys(want)
    kinds = lambda run: [_keys(h) for h in run["history"]]  # noqa: E731
    if same_steps:
        assert kinds(got) == kinds(want)
    else:
        assert set(map(tuple, kinds(got))) == set(map(tuple, kinds(want)))
    for key in ("n_train", "num_missing", "test_support_0", "test_support_1"):
        assert got[key] == want[key], key


def test_train_joint_roberta_prints_the_jax_scripts_keys(
        storage, jax_roberta_run, tmp_path):
    with _storage(storage):
        got = train_joint.main(
            ["--dataset", "demo", "--sample", "--encoder", "roberta",
             "--do_train", "--do_test", "--epochs", "1", "--output_dir",
             str(tmp_path)] + CPU)
    _same_shape(got, jax_roberta_run)
    assert (tmp_path / "epoch_0" / "meta.json").is_file()
    # --do_test alone restores the newest epoch_* and scores the same
    with _storage(storage):
        again = train_joint.main(
            ["--dataset", "demo", "--sample", "--encoder", "roberta",
             "--do_test", "--output_dir", str(tmp_path)] + CPU)
    assert again["test_loss"] == pytest.approx(got["test_loss"], abs=1e-6)


def test_train_joint_linevul_fusion_preset_runs_codebert_width(
        storage, jax_roberta_run, tmp_path):
    """The preset's CodeBERT-base encoder (seeded) and the frozen GGNN
    under the fusion head, block cut to 32 for the CPU."""
    with _storage(storage):
        got = train_joint.main(
            ["--preset", "linevul_fusion", "--dataset", "demo", "--sample",
             "--block_size", "32", "--epochs", "1", "--do_train", "--do_test",
             "--output_dir", str(tmp_path)] + CPU)
    _same_shape(got, jax_roberta_run, same_steps=False)
    state = torch.load(tmp_path / "epoch_0" / "state.pt", weights_only=True)
    assert state["llm.embeddings.word_embeddings.weight"].shape == (50265, 768)
    assert any(k.startswith("fusion.flowgnn_encoder.") for k in state)


def test_encoder_contradicting_the_preset_is_refused_as_jax():
    argv = ["--preset", "linevul", "--encoder", "llama"]
    with pytest.raises(SystemExit, match="contradicts preset") as want:
        _load_script("train_joint").main(argv)
    with pytest.raises(SystemExit, match="contradicts preset") as got:
        train_joint.main(argv + CPU)
    assert str(got.value) == str(want.value)


def test_performance_evaluation_prints_the_jax_scripts_keys(storage,
                                                            tmp_path):
    argv = ["--runs", "1", "--set", "data.dsname=demo",
            "--set", "optim.max_epochs=1"]
    with _storage(storage):
        want = _load_script("performance_evaluation").main(
            argv + ["--out", str(tmp_path / "jax")])
        got = performance_evaluation.main(
            argv + ["--out", str(tmp_path / "port")] + CPU)
    assert _keys(got) == _keys(want)
    assert _keys(got["runs"][0]) == _keys(want["runs"][0])
    assert got["backend"] == want["backend"] == "cpu"
    assert (tmp_path / "port" / "performance_evaluation.json").is_file()


def test_performance_evaluation_full_protocol_runs_three_stages(tmp_path):
    """The reference's three stages; the JAX script's stage names and
    keys."""
    with _storage(tmp_path / "storage"):
        got = performance_evaluation.main(
            ["--runs", "1", "--protocol", "full", "--out",
             str(tmp_path / "out"), "--set", "optim.max_epochs=1"] + CPU)
    assert _keys(got) == ["backend", "protocol", "runs", "stages",
                          "total_seconds"]
    assert list(got["stages"]) == ["deepdfa", "linevul", "deepdfa_linevul"]
    assert _keys(got["stages"]["deepdfa"]) == ["seconds", "test_F1Score"]
    for stage in ("linevul", "deepdfa_linevul"):
        assert _keys(got["stages"][stage]) == ["seconds", "test_f1_weighted"]
    assert (tmp_path / "out" / "combined" / "epoch_1").is_dir()


# ----------------------------------------- --hf-checkpoint on written dirs


def _hf_llama_dir(path: Path, seed: int = 2) -> dict:
    """A local HF CodeLlama directory of ``tiny_llama``'s shapes (HF names,
    a rotary buffer, ``config.json``); returns its state dict."""
    import json

    from deepdfa_tpu_torch.llm import llama as tl

    cfg = tl.tiny_llama()
    state = {k: v.clone() for k, v in tl.build_llama(
        cfg, "cpu", seed=seed, cls=tl.LlamaForCausalLM).state_dict().items()}
    saved = dict(state)
    saved["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(saved, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps(dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        dtype="float32", model_type="llama")))
    return state


def test_hf_checkpoint_llama_loads_with_fresh_adapters(tmp_path):
    """``finetune_llm.hf_llama`` and ``train_joint.hf_encoder`` over a
    written HF directory: every base tensor as written, adapters drawn
    with ``B`` zero (a no-op), the outputs the written model's."""
    from deepdfa_tpu_torch.llm import llama as tl

    state = _hf_llama_dir(tmp_path / "llama")
    lm = finetune_llm.hf_llama(tmp_path / "llama", "cpu", lora_rank=4)
    got = lm.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items())
    assert lm.cfg.lora_rank == 4 and all(
        float(got[k].abs().max()) == 0 for k in got if k.endswith("lora_b"))
    cfg, enc = train_joint.hf_encoder(
        "llama", tl.tiny_llama(lora_rank=4), tmp_path / "llama", "cpu")
    assert cfg.lora_rank == 4 and isinstance(enc, tl.LlamaModel)
    base = tl.build_llama(tl.tiny_llama(), "cpu", seed=None,
                          cls=tl.LlamaForCausalLM)
    base.load_state_dict(state)
    ids = torch.randint(3, 320, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(lm(ids), base(ids))
        assert torch.equal(enc(ids), base.model(ids))


def test_hf_checkpoint_codebert_loads_through_convert_hf_roberta(tmp_path):
    """``train_joint.hf_encoder("roberta")`` over a written CodeBERT
    directory (``roberta.``-prefixed, with a pooler and a classifier)."""
    import dataclasses
    import json

    from deepdfa_tpu_torch.llm import roberta as tr

    cfg = tr.tiny_roberta()
    want = tr.build_roberta(cfg, "cpu", seed=3)
    saved = {f"roberta.{k}": v.clone() for k, v in want.state_dict().items()}
    saved["roberta.pooler.dense.weight"] = torch.zeros(64, 64)
    saved["classifier.out_proj.weight"] = torch.zeros(2, 64)
    (tmp_path / "cb").mkdir()
    torch.save(saved, tmp_path / "cb" / "pytorch_model.bin")
    (tmp_path / "cb" / "config.json").write_text(json.dumps(
        {**dataclasses.asdict(cfg), "model_type": "roberta"}))
    got_cfg, enc = train_joint.hf_encoder("roberta", None, tmp_path / "cb",
                                          "cpu")
    assert got_cfg == cfg
    assert all(torch.equal(enc.state_dict()[k], v)
               for k, v in want.state_dict().items())


@pytest.mark.parametrize("entry", ["finetune_llm", "train_joint"])
def test_hf_checkpoint_without_transformers_stops_naming_it(tmp_path,
                                                            entry):
    """Neither machine has ``transformers``: an ``--hf-checkpoint`` run
    stops at the tokenizer, naming the package."""
    import sys

    _hf_llama_dir(tmp_path / "llama")
    argv = ["--hf-checkpoint", str(tmp_path / "llama"), "--output_dir",
            str(tmp_path / "out")] + CPU
    if entry == "train_joint":
        main, argv = train_joint.main, argv + ["--no_flowgnn"]
    else:
        main = finetune_llm.main
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        with pytest.raises(SystemExit, match="'transformers' package"):
            main(argv)
