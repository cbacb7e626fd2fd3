"""``scan_paths`` of the port against the JAX package's, on the CPU: the
fixtures (the ten ``realworld`` files and ``interproc/cross_taint.c``)
scanned by both packages with the same vocabularies, the GGNN weights
carried across by ``bridge.flax_to_torch`` and the level-2 weights by
``bridge.level2_flax_to_torch``. The JAX side scores in the segment layout
(and embeds level 1 through its Pallas encoder in interpret mode, one jit
computation); the port scores through the fused layout's plain version.

Tolerances: rows (file, function, error, cache_hit) and the
interprocedural findings equal exactly; tier-1 probabilities and the unit
score within 1e-5 (both sides round to 6 decimals; the products sum in
another order than XLA's).

A second test writes a JAX cache entry into a directory and scans it with
the port in a subprocess where the JAX package cannot be imported: the
entry is a miss and nothing of ``deepdfa_tpu`` is imported.
"""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.extract_cache import ExtractCache as JCache  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.pipeline import vocab_content_hash as jvocab_hash  # noqa: E402
from deepdfa_tpu.scan import scan_paths as jscan  # noqa: E402
from deepdfa_tpu.serve.engine import ScoringEngine as JEngine  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.scan import collect_c_files, scan_paths  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
INPUT_DIM = JFeatureConfig().input_dim
ATOL = 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixtures as one source tree, plus a file that does not parse."""
    root = tmp_path_factory.mktemp("src")
    for p in sorted((FIXTURES / "realworld").glob("*.c")):
        shutil.copy(p, root / p.name)
    (root / "interproc").mkdir()
    shutil.copy(FIXTURES / "interproc" / "cross_taint.c",
                root / "interproc" / "cross_taint.c")
    (root / "broken.c").write_text("int f( {{{ not C at all")
    return root


@pytest.fixture(scope="module")
def vocabs():
    rows = demo_corpus(24, seed=3).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    _, jvocabs = CorpusBuilder(JFeatureConfig()).build(
        cpgs, list(cpgs), graph_labels={k: 0 for k in cpgs})
    tvocabs = {k: Vocabulary.from_dict(v.to_dict()) for k, v in jvocabs.items()}
    return jvocabs, tvocabs


@pytest.fixture(scope="module")
def engines(vocabs):
    jvocabs, _ = vocabs
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    g = jencode((FIXTURES / "realworld" / "ptr_walk.c").read_text(),
                jvocabs)[0].graph
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 64, 256))
    params = jmodel.init(jax.random.key(1), example)["params"]
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=8)
    cfg = GGNNConfig(**SMALL, layout="fused")
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params), cfg,
                                 INPUT_DIM)
    teng = ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu"),
                                    state, "graph", feat_keys=KEYS,
                                    max_batch=8, device="cpu")
    teng.hier.level2.load_state_dict(bridge.level2_flax_to_torch(
        jax.tree.map(np.asarray, jeng.hier._l2_params)))
    return jeng, teng


def _row_keys(report):
    return [(Path(r["file"]).name, r.get("function"), r.get("error"),
             r.get("cache_hit")) for r in report["results"]]


def test_scan_reports_equal_jax(tree, vocabs, engines, tmp_path):
    jvocabs, tvocabs = vocabs
    jeng, teng = engines
    kw = dict(n_workers=3, interproc=True)
    want = jscan([tree], jvocabs, engine=jeng, cache_dir=tmp_path / "jax",
                 **kw)
    got = scan_paths([tree], tvocabs, engine=teng,
                     cache_dir=tmp_path / "port", **kw)
    assert got["n_files"] == want["n_files"] == 12
    assert _row_keys(got) == _row_keys(want)
    assert got["n_errors"] == want["n_errors"] == 1
    assert got["n_scored"] == want["n_scored"] == 12
    for a, b in zip(got["results"], want["results"]):
        if "vulnerable_probability" in b:
            assert a["vulnerable_probability"] == pytest.approx(
                b["vulnerable_probability"], abs=ATOL)
    gi, wi = got["interproc"], want["interproc"]
    for key in ("findings", "attribution", "call_edges", "functions",
                "n_files_parsed", "n_files_reused"):
        assert gi[key] == wi[key], key
    assert gi["findings"] and gi["call_edges"] == 1
    assert gi["n_files_reused"] == 11  # the parse of the encode, reused
    gu, wu = gi["unit"], wi["unit"]
    assert gu["n_functions"] == wu["n_functions"] == 12
    assert gu["call_edges"] == wu["call_edges"]
    assert gu["unit_score"] == pytest.approx(wu["unit_score"], abs=ATOL)
    assert [r["function"] for r in gu["attribution"]] == [
        r["function"] for r in wu["attribution"]]
    for a, b in zip(gu["attribution"], wu["attribution"]):
        assert a["weight"] == pytest.approx(b["weight"], abs=ATOL)
        assert a["score"] == pytest.approx(b["score"], abs=ATOL)
    assert gu["level1"]["dispatches"] >= 1
    assert gu["level1"]["recompute"] == 12

    # a warm rescan hits every encodable file and every embedding
    teng.hier.reset_counters()
    warm = scan_paths([tree], tvocabs, engine=teng,
                      cache_dir=tmp_path / "port", **kw)
    assert warm["pool"]["extracted"] == 0
    assert warm["cache"]["hits"] == 11 and warm["cache"]["misses"] == 1
    assert all(r["cache_hit"] for r in warm["results"] if "function" in r)
    assert [r.get("vulnerable_probability") for r in warm["results"]] == [
        r.get("vulnerable_probability") for r in got["results"]]
    wu2 = warm["interproc"]["unit"]
    assert wu2["unit_score"] == gu["unit_score"]
    assert wu2["level1"]["dispatches"] == 0
    assert wu2["level1"]["recompute"] == 0
    assert wu2["level1"]["fallback_dispatches"] == 0
    # the cached encodings of an interprocedural scan carry their CPGs
    assert warm["interproc"]["n_files_reused"] == 11
    assert warm["interproc"]["findings"] == gi["findings"]


class _Tier2:
    model_rev = "tier2-test"

    def __init__(self, fail=False):
        self.fail, self.calls = fail, []

    def score(self, items):
        if self.fail:
            raise RuntimeError("tier 2 down")
        self.calls.append(items)
        return np.full(len(items), 0.5, np.float32)


def test_cascade_band_and_degradation(tree, vocabs, engines):
    _, tvocabs = vocabs
    _, teng = engines
    base = scan_paths([tree], tvocabs, engine=teng, n_workers=2)
    probs = sorted(r["vulnerable_probability"] for r in base["results"]
                   if "vulnerable_probability" in r)
    band = (probs[2], probs[-3])
    t2 = _Tier2()
    rep = scan_paths([tree], tvocabs, engine=teng, tier2=t2,
                     tier2_band=band, n_workers=2)
    inside = [r for r in rep["results"] if r.get("tier") == 2]
    assert len(inside) == rep["cascade"]["n_tier2"] == len(probs) - 4
    assert all(band[0] <= r["tier1_score"] <= band[1] for r in inside)
    assert all(r["vulnerable_probability"] == 0.5 for r in inside)
    src, g = t2.calls[0][0]
    assert "(" in src and g.n_nodes > 0
    bad = scan_paths([tree], tvocabs, engine=teng, tier2=_Tier2(fail=True),
                     tier2_band=band, n_workers=2)
    assert bad["cascade"]["n_degraded"] == len(inside)
    assert bad["cascade"]["n_tier2"] == 0
    assert collect_c_files([tree]) == sorted(tree.rglob("*.c"))
    with pytest.raises(FileNotFoundError):
        collect_c_files([tree / "missing.c"])


def test_a_jax_cache_dir_is_a_miss_and_imports_nothing_of_jax(
        tree, vocabs, tmp_path):
    jvocabs, _ = vocabs
    cache_dir = tmp_path / "shared"
    jscan([tree], jvocabs, cache_dir=cache_dir, n_workers=2)
    jcache = JCache(cache_dir, salt=jvocab_hash(jvocabs))
    code = (tree / "ptr_walk.c").read_text()
    assert jcache.get(jcache.key(code)) is not None  # the JAX entry is there
    (tmp_path / "vocab.json").write_text(json.dumps(
        {k: v.to_dict() for k, v in jvocabs.items()}))
    script = textwrap.dedent(f"""
        import importlib.abc, json, shutil, sys
        from pathlib import Path
        tried = []

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "deepdfa_tpu" or name.startswith("deepdfa_tpu."):
                    tried.append(name)
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        from deepdfa_tpu_torch.data.extract_cache import ExtractCache
        from deepdfa_tpu_torch.pipeline import load_vocabs, vocab_content_hash
        from deepdfa_tpu_torch.scan import scan_paths

        cache_dir = Path({str(cache_dir)!r})
        vocabs = load_vocabs({str(tmp_path)!r})
        cache = ExtractCache(cache_dir, salt=vocab_content_hash(vocabs))
        code = Path({str(tree / "ptr_walk.c")!r}).read_text()
        # a JAX pickle under the port's own key: refused, never imported
        src = {str(cache_dir)!r} + "/" + {jcache.key(code)!r}
        shutil.copy(src + ".pkl", cache_dir / (cache.key(code) + ".pkl"))
        shutil.copy(src + ".json", cache_dir / (cache.key(code) + ".json"))
        report = scan_paths([{str(tree)!r}], vocabs, cache_dir=cache_dir,
                            n_workers=2)
        bad = sorted(n for n in sys.modules if n.split(".")[0] == "deepdfa_tpu")
        print(json.dumps({{"cache": report["cache"], "tried": tried,
                          "modules": bad,
                          "hits": sum(r.get("cache_hit", False)
                                      for r in report["results"])}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["tried"] == [] and out["modules"] == []
    assert out["hits"] == 0 and out["cache"]["hits"] == 0
    assert out["cache"]["corrupt"] == 1  # the planted entry
    assert out["cache"]["misses"] == 12
