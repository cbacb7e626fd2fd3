"""The port's two cache fault points against the JAX package's.

``extract.cache_corrupt`` (``data/extract_cache.py``) and
``embcache.cache_corrupt`` (``serve/embcache.py``) corrupt one read's
payload; the read is then a miss (counted as corrupt), never an exception.
Each test arms the same ``DEEPDFA_FAULTS`` spec in both packages, reads the
same committed entries in the same order, and holds the hit/miss sequence,
the fired hits and the cache stats equal. Exact comparisons: nothing here
is floating point.
"""

import numpy as np
import pytest

from deepdfa_tpu.data.extract_cache import ExtractCache as JExtractCache
from deepdfa_tpu.resilience import faults as jfaults
from deepdfa_tpu.serve.embcache import FunctionEmbeddingCache as JEmbCache

from deepdfa_tpu_torch.data.extract_cache import ExtractCache
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.serve.embcache import FunctionEmbeddingCache

SOURCES = [f"int f{i}(int x) {{ return x + {i}; }}" for i in range(8)]
SPECS = ["{p}@2,5", "{p}:p=0.5:seed=3", "{p}@1:max=1"]


def _reads(cache, values, point, spec, fault_mod):
    """Commit ``values`` under the sources' keys, then read each twice with
    ``spec`` armed: (per read, whether it hit), the point's counters and the
    stats."""
    keys = [cache.key(src) for src in SOURCES]
    for key, value in zip(keys, values):
        cache.put(key, value)
    with fault_mod.installed(spec.format(p=point)):
        hits = [cache.get(key) is not None for key in keys + keys]
        counters = fault_mod.counters()
    return hits, counters, cache.stats()


@pytest.mark.parametrize("spec", SPECS)
def test_extract_cache_corrupt_fires_as_in_jax(tmp_path, spec):
    values = [{"function": i, "rows": list(range(i))} for i in range(8)]
    mine = _reads(ExtractCache(tmp_path / "port", salt="v"), values,
                  "extract.cache_corrupt", spec, faults)
    ref = _reads(JExtractCache(tmp_path / "jax", salt="v"), values,
                 "extract.cache_corrupt", spec, jfaults)
    assert mine == ref
    hits, _, stats = mine
    assert stats["corrupt"] == hits.count(False) > 0
    assert stats["hits"] == hits.count(True)


@pytest.mark.parametrize("spec", SPECS)
def test_embcache_corrupt_fires_as_in_jax(tmp_path, spec):
    rng = np.random.default_rng(0)
    values = [rng.standard_normal(16).astype(np.float32) for _ in range(8)]
    kw = dict(model_rev="rev", vocab_hash="abc", dim=16)
    mine = _reads(FunctionEmbeddingCache(tmp_path / "port", **kw), values,
                  "embcache.cache_corrupt", spec, faults)
    ref = _reads(JEmbCache(tmp_path / "jax", **kw), values,
                 "embcache.cache_corrupt", spec, jfaults)
    assert mine == ref
    hits, _, stats = mine
    assert stats["corrupt"] == hits.count(False) > 0


def test_a_disarmed_point_leaves_every_read_a_hit(tmp_path):
    cache = ExtractCache(tmp_path)
    key = cache.key(SOURCES[0])
    cache.put(key, {"x": 1})
    assert cache.get(key) == {"x": 1}
    assert cache.stats()["corrupt"] == 0


def test_the_env_var_arms_both_packages_alike(tmp_path, monkeypatch):
    """``DEEPDFA_FAULTS`` read by each package's ``install_from_env``: the
    armed hit of each point turns a committed entry into a miss, in both
    packages alike."""
    monkeypatch.setenv("DEEPDFA_FAULTS",
                       "extract.cache_corrupt@2;embcache.cache_corrupt@1")
    seen = []
    for mod, extract, emb in ((faults, ExtractCache, FunctionEmbeddingCache),
                              (jfaults, JExtractCache, JEmbCache)):
        root = tmp_path / mod.__name__
        try:
            assert mod.install_from_env()
            cache = extract(root / "extract")
            key = cache.key(SOURCES[0])
            cache.put(key, {"rows": [1, 2]})
            ecache = emb(root / "emb", model_rev="rev", vocab_hash="abc",
                         dim=4)
            ekey = ecache.key(SOURCES[0])
            ecache.put(ekey, np.ones(4, np.float32))
            seen.append(([cache.get(key) is not None for _ in range(3)],
                         [ecache.get(ekey) is not None for _ in range(2)]))
        finally:
            mod.clear()
    assert seen[0] == seen[1] == ([True, False, True], [False, True])
