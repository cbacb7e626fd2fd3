"""The port's dataset readers and their pandas-free table layer against the
JAX package's (pandas) on the CPU: the same written files through both.

- ``data/table.py`` against pandas: ``read_csv`` on a full-schema MSR CSV
  (the leading unnamed index, NA strings, quoted fields that span lines
  with doubled quotes, blank lines, a function longer than Python's
  default field limit, typed columns), ``read_json`` of an array and of
  JSON lines, and ``to_csv``'s bytes;
- the readers: ``bigvul`` (every quality filter, the vulnerable-only rule,
  a CSV without an index column, the process pool), ``devign``,
  ``diversevul`` (list, null and missing ``cwe``/``message``), ``mutated``
  (flip and non-flip, a repeated ``idx``), ``ds``, and the readers' cache;
- ``filter_dataset`` (``sample``, ``vulonly``, ``check_file``,
  ``check_valid`` through a validity cache each package reads from the
  other), the split readers, ``partition`` in all four split modes and
  ``VulnDataset``.

Every table, split and cache file is compared exactly (a NaN equals a
NaN). Every test points ``DEEPDFA_STORAGE`` at a temporary directory.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from deepdfa_tpu.data import ingest as jingest  # noqa: E402

from deepdfa_tpu_torch.data import codegen, ingest, table  # noqa: E402

NAN_MARK = "<NaN>"


def plain(value):
    """``value`` with NaN replaced by a marker and numpy scalars by Python
    ones, so that equal tables compare equal."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, np.ndarray)):
        return [plain(v) for v in value]
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and math.isnan(value):
        return NAN_MARK
    return value


def records(df) -> list[dict]:
    return [plain(r) for r in df.to_dict("records")]


def assert_table_equal(rows, df):
    """The port's table equals the pandas frame: columns, rows, labels."""
    assert rows.columns == list(df.columns)
    assert [plain(r) for r in rows] == records(df)
    assert rows.index == df.index.tolist()


@pytest.fixture(autouse=True)
def storage(tmp_path, monkeypatch):
    root = tmp_path / "storage"
    monkeypatch.setenv("DEEPDFA_STORAGE", str(root))
    return root


# ------------------------------------------------------------ the files

BEFORE = (
    "static int copy_data(char *dst, const char *src, int n)\n"
    "{\n"
    "  int i; /* index */\n"
    "  for (i = 0; i < n; i++)\n"
    "    dst[i] = src[i];  // copy\n"
    "  return i;\n"
    "}\n"
)
AFTER = BEFORE.replace("  for", "  if (n > 64)\n    n = 64;\n  for")
LONG = ("int huge(int x)\n{\n" + "  x = x + 1;\n" * 12_000 + "  return x;\n}\n")
SIX = "int f(int x)\n{\n  int a = 1;\n  int b = 2;\n  int c = 3;\n  return x;\n}\n"


def _msr_base(i: int) -> dict:
    """Every typed column of the reference reader (``datasets.py:161-196``)."""
    return {
        "commit_id": f"{i:07d}" if i % 3 == 0 else f"c{i:07x}",
        "del_lines": i % 4, "file_name": f"drivers/net/f{i}.c", "lang": "C",
        "lines_after": "12,13", "lines_before": "12",
        "Access Gained": "None", "Attack Origin": "Remote",
        "Authentication Required": "Not required", "Availability": "Partial",
        "CVE ID": f"CVE-2018-{1000000 + i}",
        "CVE Page": "https://www.cvedetails.com/cve/CVE-2018-1000001/",
        "CWE ID": "CWE-787" if i % 2 else "NA", "Complexity": "Low",
        "Confidentiality": "Partial", "Integrity": "Partial",
        "Known Exploits": "", "Score": 7.5 - i / 8,
        "Summary": 'Out-of-bounds write, "quoted",\nsecond line.',
        "Vulnerability Classification": "Overflow", "add_lines": i % 3,
        "codeLink": "https://github.com/example/repo/commit/deadbeef0123",
        "commit_message": "fix OOB write", "files_changed": "f.c",
        "parentID": "cafebabe4567", "patch": "@@ -3,0 +4,2 @@",
        "project": "linux" if i % 5 else "00123", "project_after": "linux",
        "project_before": "linux", "vul_func_with_fix": AFTER,
        "Publish Date": "2018-02-01", "Update Date": "2019-03-02",
    }


def msr_rows(n_generated: int = 24) -> list[dict]:
    """Rows for every path through the Big-Vul reader: generated pairs (half
    vulnerable, a dataflow-hard one), the bound-check patch, one row each
    filter drops, a row whose ``vul`` is neither 0 nor 1, and a function
    longer than Python's default CSV field limit."""
    rng = np.random.default_rng(0)
    pairs = []
    for i in range(n_generated):
        r = (codegen.generate_hard_function(i, i % 2 == 0, rng, chain_depth=4)
             if i == 7 else codegen.generate_function(i, i % 2 == 0, rng))
        pairs.append((r["before"], r["after"], r["vul"]))
    pairs += [
        (BEFORE, AFTER, 1),                                   # kept
        (SIX, SIX, 1),                                        # no change
        (SIX + "int g(", SIX, 1),                             # abnormal before
        (SIX, SIX + "int g(", 1),                             # abnormal after
        (SIX + "foo(x);", SIX + "foo(y);", 1),                # ends in ");"
        ("int a;\nint b;\nint c;\nint d;\nint e;\nint f;",
         "int g;\nint h;\nint i;\nint j;\nint k;\nint l;", 1),  # share >= 0.7
        ("int f(int x)\n{\n  return x;\n}",
         "int f(int x)\n{\n  return x + 1;\n}", 1),           # <= 5 lines
        (SIX, SIX.replace("3", "4"), 2),                      # vul 2
        (LONG, LONG, 0),                                      # > 131,072 chars
    ]
    return [dict(_msr_base(i), func_before=b, func_after=a, vul=v)
            for i, (b, a, v) in enumerate(pairs)]


def write_msr(path: Path, index: bool = True, n_generated: int = 24) -> Path:
    """The MSR CSV as pandas writes it (``index=True``: the real file's
    leading unnamed column), with blank lines between some records."""
    path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(msr_rows(n_generated)).to_csv(path, index=index)
    lines = path.read_text().split("\n")
    text = "\n".join(lines[:3] + [""] + lines[3:])
    path.write_text(text + "\n\n")
    return path


def devign_objs(n: int = 60) -> list[dict]:
    rng = np.random.default_rng(1)
    objs = []
    for i in range(n):
        r = codegen.generate_function(i, i % 3 == 0, rng)
        func = r["before"].replace("{\n", "{\n\n  /* c */\n", 1)
        if i % 11 == 5:
            func = func.rstrip().rstrip("}")             # abnormal ending
        if i % 13 == 6:
            func = func + "\nMACRO(x);"                  # ends in ");"
        objs.append({"project": "qemu" if i % 2 else "FFmpeg",
                     "commit_id": f"{i:040x}", "target": r["vul"],
                     "func": func})
    return objs


def diversevul_objs(n: int = 30) -> list[dict]:
    rng = np.random.default_rng(2)
    objs = []
    for i in range(n):
        r = codegen.generate_function(i, i % 2 == 0, rng)
        o = {"func": r["before"], "target": r["vul"],
             "cwe": [f"CWE-{787 + i}", "CWE-20"][: 1 + i % 2],
             "project": "openssl", "commit_id": f"{i:040x}",
             "hash": 10 ** 17 + i, "size": 7 + i, "message": f"fix {i}"}
        if i % 5 == 1:
            o["cwe"] = None
        if i % 5 == 2:
            del o["cwe"]
        if i % 7 == 3:
            o["message"] = None
        if i % 7 == 4:
            del o["message"]
        if i == 9:
            o["func"] = o["func"].rstrip().rstrip("}")
        objs.append(o)
    return objs


def write_json(path: Path, objs: list[dict], lines: bool) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(json.dumps(o) for o in objs) + "\n" if lines
                    else json.dumps(objs))
    return path


# ------------------------------------------------------------ table layer


@pytest.mark.parametrize("index", [True, False])
def test_read_csv_matches_pandas(tmp_path, index):
    path = write_msr(tmp_path / "msr.csv", index=index)
    want = pd.read_csv(path, dtype={"commit_id": str, "project": str})
    got = table.read_csv(path, str_columns=("commit_id", "project"))
    assert_table_equal(got, want)
    assert ("Unnamed: 0" in got.columns) == index
    assert any(len(r["func_before"]) > 131_072 for r in got)
    assert isinstance(got[0]["del_lines"], int)


def test_read_csv_types_columns_as_pandas(tmp_path):
    text = (',a,b,c,d,e,f,g,h,a\n'
            '0,1,x,True,1.5,,None, 12 ,+5,7\n'
            '\n'
            '1,2,"q""uote\nline",False,2,NA,y,3,-inf,8\n'
            '2,3,z,,1e3,,z,4,007,9\n'
            '3,4,w,true\n')
    path = tmp_path / "t.csv"
    path.write_text(text)
    assert_table_equal(table.read_csv(path), pd.read_csv(path))


@pytest.mark.parametrize("lines", [False, True])
def test_read_json_matches_pandas(tmp_path, lines):
    objs = diversevul_objs()
    objs[4]["numeric_text"] = "12"
    objs[5]["flag"] = True
    for i, o in enumerate(objs):
        o["digits"] = f"{i:03d}"
        o["halves"] = i / 2
        o["ones"] = 1.0
    path = write_json(tmp_path / "d.json", objs, lines)
    want = pd.read_json(path, lines=lines)
    got = table.read_json(path, lines=lines)
    assert_table_equal(got, want)
    assert got[0]["digits"] == 0 and got[0]["ones"] == 1


def test_write_csv_bytes_equal_pandas(tmp_path):
    rows = table.Rows([{"id": 5, "valid": True, "s": "a,b"},
                       {"id": 7, "valid": False, "s": 'q"x\ny'}],
                      index=[3, 9])
    got = table.write_csv(tmp_path / "port.csv", rows)
    pd.DataFrame(list(rows), index=rows.index).to_csv(tmp_path / "pd.csv")
    assert got == (tmp_path / "pd.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == got


# ------------------------------------------------------------ readers


@pytest.mark.parametrize("index", [True, False])
def test_bigvul_matches_jax(tmp_path, index):
    path = write_msr(tmp_path / "msr.csv", index=index)
    want = jingest.bigvul(csv_path=path, cache=False, workers=1)
    stats = {}
    got = ingest.bigvul(path, cache=False, workers=1, stats=stats)
    assert_table_equal(got, want)
    n = len(msr_rows())
    assert stats["rows"] == n and stats["kept"] == len(want)
    # one row each filter drops, and the row whose vul is 2
    assert all(stats["dropped"][k] >= 1 for k in stats["dropped"])
    assert stats["kept_vulnerable"] == int((want.vul == 1).sum())
    assert stats["vulnerable"] - sum(stats["dropped"].values()) == \
        stats["kept_vulnerable"]
    assert n - stats["kept"] == sum(stats["dropped"].values()) + 1


def test_bigvul_over_a_process_pool_keeps_row_order(tmp_path):
    path = write_msr(tmp_path / "msr.csv", n_generated=80)
    serial = ingest.bigvul(path, cache=False, workers=1)
    pooled = ingest.bigvul(path, cache=False, workers=3)
    assert pooled == serial and pooled.columns == serial.columns
    assert [r["id"] for r in pooled] == sorted(r["id"] for r in pooled)


def test_label_diffs_matches_jax():
    rows = msr_rows(8)
    want = jingest.label_diffs(pd.DataFrame(rows), workers=1)
    assert_table_equal(ingest.label_diffs(table.Rows(rows), workers=1), want)


def test_devign_matches_jax(tmp_path):
    path = write_json(tmp_path / "function.json", devign_objs(), False)
    want = jingest.devign(json_path=path, cache=False)
    got = ingest.devign(path, cache=False)
    assert_table_equal(got, want)
    assert len(got) < 60 and {r["vul"] for r in got} == {0, 1}
    assert_table_equal(ingest.devign(path, cache=False, sample=True),
                       jingest.devign(json_path=path, cache=False, sample=True))


def test_diversevul_matches_jax(tmp_path):
    path = write_json(tmp_path / "dv.json", diversevul_objs(), True)
    want = jingest.diversevul(json_path=path, cache=False)
    got = ingest.diversevul(path, cache=False)
    assert_table_equal(got, want)
    cwes = {r["cwe"] for r in got}
    assert "" in cwes and "CWE-790,CWE-20" in cwes
    assert "" in {r["message"] for r in got}
    assert "nan" not in {r["message"] for r in got} | cwes


def write_mutated(storage: Path, name: str) -> None:
    """``external/mutated/c_{name}.jsonl``: source/target over Big-Vul ids,
    one id repeated, one missing from Big-Vul."""
    objs = [{"idx": i, "source": f"int s{i}(void) {{ return {i}; }}",
             "target": f"int t{i}(void) {{ return {i}; }}"}
            for i in (3, 0, 5, 3, 999, 1)]
    write_json(storage / "external" / "mutated" / f"c_{name}.jsonl", objs, True)


@pytest.mark.parametrize("name", ["rename", "rename_flip"])
def test_mutated_matches_jax(storage, name):
    write_msr(storage / "external" / "MSR_data_cleaned.csv")
    write_mutated(storage, name.replace("_flip", ""))
    want = jingest.mutated(name, cache=False)
    got = ingest.mutated(name, cache=False, workers=1)
    assert_table_equal(got, want)
    assert [r["idx"] for r in got].count(3) == 2


def test_ds_dispatches_like_jax(storage):
    write_msr(storage / "external" / "MSR_data_cleaned.csv")
    write_json(storage / "external" / "function.json", devign_objs(), False)
    write_json(storage / "external" / "diversevul.json", diversevul_objs(), True)
    write_mutated(storage, "dead")
    for name in ("bigvul", "devign", "diversevul", "mutated_dead"):
        assert_table_equal(ingest.ds(name, cache=False, workers=1),
                           jingest.ds(name, cache=False))
    for reader in (ingest.ds, jingest.ds):
        with pytest.raises(ValueError, match="unknown dataset"):
            reader("nope")


def test_readers_cache_is_the_ports_own(storage, tmp_path):
    write_msr(storage / "external" / "MSR_data_cleaned.csv")
    cache_dir = storage / "cache" / "minimal_datasets"
    cache_dir.mkdir(parents=True)
    # a JAX-side pickled frame under the JAX name is never read
    (cache_dir / "minimal_bigvul.pkl").write_bytes(b"not a pickle the port reads")
    custom = ingest.bigvul(write_msr(tmp_path / "other.csv"), workers=1)
    assert not list(cache_dir.glob("port_*"))       # a custom path fills nothing
    first = ingest.bigvul(workers=1)
    assert (cache_dir / "port_minimal_bigvul.json").exists()
    (storage / "external" / "MSR_data_cleaned.csv").unlink()
    assert ingest.bigvul(workers=1) == first == custom
    assert ingest.bigvul(workers=1).columns == first.columns


# ------------------------------------------------------------ filters


def _reader_table(storage):
    path = write_msr(storage / "external" / "MSR_data_cleaned.csv",
                     n_generated=40)
    return (ingest.bigvul(path, cache=False, workers=1),
            jingest.bigvul(csv_path=path, cache=False, workers=1))


def _artifacts(storage, ids, valid):
    before = storage / "processed" / "bigvul" / "before"
    before.mkdir(parents=True, exist_ok=True)
    for i in ids:
        nodes = [{"id": 1, "lineNumber": 1}] if i in valid else []
        (before / f"{i}.c.nodes.json").write_text(json.dumps(nodes))
        (before / f"{i}.c.edges.json").write_text(json.dumps(
            [[1, 1, "CFG", ""]] if i in valid else []))
    (before / "~3.c.nodes.json").write_text("[]")


@pytest.mark.parametrize("opts", [
    {"sample": 17, "seed": 3},
    {"sample": 30, "seed": 0, "vulonly": True},
    {"vulonly": True, "load_code": False},
    {"check_file": True},
    {"check_valid": True, "sample": 25, "seed": 1},
])
def test_filter_dataset_matches_jax(storage, opts):
    rows, df = _reader_table(storage)
    _artifacts(storage, range(0, 40, 2), valid=set(range(0, 40, 3)))
    want = jingest.filter_dataset(df, "bigvul", **opts)
    got = ingest.filter_dataset(rows, "bigvul", **opts)
    assert_table_equal(got, want)


def test_validity_cache_is_shared_both_ways(storage):
    rows, df = _reader_table(storage)
    _artifacts(storage, range(0, 40, 2), valid=set(range(0, 40, 3)))
    cache = storage / "cache" / "bigvul_valid_False.csv"
    opts = dict(check_valid=True, sample=25, seed=1)
    want = jingest.filter_dataset(df, "bigvul", **opts)
    jax_bytes = cache.read_bytes()
    # the port reads the file pandas wrote ...
    _artifacts(storage, range(40), valid=set())   # a rescan would keep nothing
    assert_table_equal(ingest.filter_dataset(rows, "bigvul", **opts), want)
    # ... and writes the bytes pandas writes, which the JAX package reads
    cache.unlink()
    _artifacts(storage, range(0, 40, 2), valid=set(range(0, 40, 3)))
    ingest.filter_dataset(rows, "bigvul", **opts)
    assert cache.read_bytes() == jax_bytes
    _artifacts(storage, range(40), valid=set())
    assert_table_equal(ingest.filter_dataset(rows, "bigvul", **opts),
                       jingest.filter_dataset(df, "bigvul", **opts))


def test_filter_dataset_validity_fn_and_nothing_left(storage):
    rows, df = _reader_table(storage)
    fn = lambda i: i % 4 == 1  # noqa: E731
    assert_table_equal(
        ingest.filter_dataset(rows, "bigvul", check_valid=True, validity_fn=fn),
        jingest.filter_dataset(df, "bigvul", check_valid=True, validity_fn=fn))
    assert not (storage / "cache" / "bigvul_valid_False.csv").exists()
    with pytest.raises(AssertionError, match="all rows filtered out"):
        jingest.filter_dataset(df, "bigvul", check_file=True)
    with pytest.raises(ValueError, match="all rows filtered out"):
        ingest.filter_dataset(rows, "bigvul", check_file=True)


def test_check_file_rejects_the_joern_paths_file_names(storage):
    """``{id}_{digest}.c`` (the Joern path's content-addressed names) is not
    an int before its first dot: both packages raise (ROADMAP queue C)."""
    rows, df = _reader_table(storage)
    before = storage / "processed" / "bigvul" / "before"
    before.mkdir(parents=True)
    (before / "12_0123456789abcdef.c.nodes.json").write_text("[]")
    with pytest.raises(ValueError, match="invalid literal for int"):
        jingest.filter_dataset(df, "bigvul", check_file=True)
    with pytest.raises(ValueError, match="invalid literal for int"):
        ingest.filter_dataset(rows, "bigvul", check_file=True)
    assert ingest.check_validity(12) is jingest.check_validity(12) is False


# ------------------------------------------------------------ splits


def write_splits(storage: Path, ids) -> dict:
    """The LineVul, LineVD-random, CodeXGLUE and a named split file over
    ``ids``; returns the fixed map."""
    ext = storage / "external"
    (ext / "splits").mkdir(parents=True, exist_ok=True)
    parts = ["train", "train", "valid", "test", "train"]
    fixed = {i: parts[i % 5] for i in ids}
    (ext / "linevul_splits.csv").write_text(
        "index,split\n" + "".join(f"{i},{s}\n" for i, s in fixed.items()))
    (ext / "bigvul_rand_splits.csv").write_text(
        "id,split\n" + "".join(f"{i},{parts[(i + 2) % 5]}\n" for i in ids))
    (ext / "codexglue_splits.csv").write_text(
        "example_index,split\n" + "".join(f"{i},{s}\n" for i, s in fixed.items()))
    (ext / "splits" / "cp_0.csv").write_text(
        ",example_index,split\n" + "".join(
            f"{k},{i},{'holdout' if i % 3 == 0 else 'valid' if i % 3 == 1 else 'train'}\n"
            for k, i in enumerate(ids)))
    return {i: s.replace("valid", "val") for i, s in fixed.items()}


def test_split_readers_match_jax(storage):
    write_splits(storage, range(0, 40, 1))
    assert ingest.linevul_splits() == jingest.linevul_splits().to_dict()
    assert ingest.codexglue_splits() == jingest.codexglue_splits().to_dict()
    assert ingest.named_splits("cp_0") == jingest.named_splits("cp_0").to_dict()
    for name in ("bigvul", "mutated_x", "devign"):
        assert ingest.splits_map(name) == jingest.splits_map(name)
    for smap in (ingest.splits_map, jingest.splits_map):
        with pytest.raises(ValueError):
            smap("diversevul")


@pytest.mark.parametrize("split", ["random", "fixed", "linevul", "cp_0"])
@pytest.mark.parametrize("part", ["all", "train", "val", "test"])
def test_partition_matches_jax(storage, split, part):
    rows, df = _reader_table(storage)
    write_splits(storage, [r["id"] for r in rows][:-3])   # 3 ids unassigned
    # sampled rows carry non-contiguous labels: the random split's quirk
    rows = ingest.filter_dataset(rows, "bigvul", sample=33, seed=5)
    df = jingest.filter_dataset(df, "bigvul", sample=33, seed=5)
    for seed in (0, 7):
        assert_table_equal(
            ingest.partition(rows, part, "bigvul", split=split, seed=seed),
            jingest.partition(df, part, "bigvul", split=split, seed=seed))


def test_partition_with_a_given_map_matches_jax(storage):
    rows, df = _reader_table(storage)
    smap = {r["id"]: ["train", "test", "val"][r["id"] % 3] for r in rows}
    for split in ("random", "fixed"):
        assert_table_equal(
            ingest.partition(rows, "all", split=split, splits=smap, seed=2),
            jingest.partition(df, "all", split=split, splits=smap, seed=2))


# ------------------------------------------------------------ VulnDataset


@pytest.mark.parametrize("resample", [
    {"undersample": "v1.0"}, {"undersample": 0.5}, {"oversample": 2.0},
    {"undersample": "v0.5", "oversample": 1.5}])
def test_vuln_dataset_matches_jax(storage, resample):
    rows, df = _reader_table(storage)
    smap = write_splits(storage, [r["id"] for r in rows])
    for part in ("train", "test"):
        kw = dict(dsname="bigvul", part=part, seed=3, check_file=False,
                  check_valid=False, splits=smap, **resample)
        got, want = ingest.VulnDataset(rows=rows, **kw), \
            jingest.VulnDataset(df=df, **kw)
        assert len(got) == len(want) and repr(got) == repr(want)
        assert got.idx2id == want.idx2id
        assert got.positive_weight() == want.positive_weight()
        for epoch in (0, 1, 4):
            for shuffle in (True, False):
                np.testing.assert_array_equal(got.epoch_ids(epoch, shuffle),
                                              want.epoch_ids(epoch, shuffle))
        for i in (0, len(got) - 1, -1):
            assert plain(got[i]) == plain(want[i])
        vul = next(r["id"] for r in got.rows if r["vul"] == 1)
        assert got.vuln_lines(vul) == want.vuln_lines(vul)


def test_vuln_dataset_reads_the_default_source(storage):
    write_msr(storage / "external" / "MSR_data_cleaned.csv")
    smap = write_splits(storage, range(40))
    _artifacts(storage, range(40), valid=set(range(40)))
    kw = dict(part="val", split="random", seed=1)
    got, want = ingest.VulnDataset(**kw), jingest.VulnDataset(**kw)
    assert [plain(r) for r in got.rows] == records(want.df) and len(got)
    assert smap
