"""The dataflow experiment's three sweeps (``--chain-sweep``, ``--rescue``,
``--union-pretrain``) in the port against ``scripts/
dataflow_experiment.py``, on the CPU, at ``demo_order2``, 40 functions and
2 epochs: each prints one JSON line with the JAX script's keys at every
level and lists of the same lengths (the curves, one gradient norm per
message-passing round at each probed epoch); every gradient norm and F1
finite. The values are not compared: the two packages draw their initial
weights from different generators (``tests/test_torch_dataflow_
experiment.py`` holds the gradient norms on shared parameters).
"""

import contextlib
import importlib.util
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu_torch import dataflow_experiment as exp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--n", "40", "--epochs", "2", "--seed", "0"]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jexp = _load_script("dataflow_experiment")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _storage(root: Path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        yield


def _shape(obj):
    """Keys at every level and list lengths; leaves collapse to one mark
    (a plateau epoch may be None in one run and a number in another)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return "leaf"


def _leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (i,))
    else:
        yield path, obj


@pytest.mark.parametrize("sweep", ["--chain-sweep", "--rescue",
                                   "--union-pretrain"])
def test_the_sweep_prints_the_jax_script_keys(sweep, tmp_path, capsys):
    argv = ARGV + [sweep, "2"]
    with _storage(tmp_path / "jax"):
        want = jexp.main(argv + ["--out", str(tmp_path / "jax_runs")])
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with _storage(tmp_path / "port"):
        got = exp.main(argv + ["--out", str(tmp_path / "port_runs"),
                               "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jline == want and line == got
    assert _shape(got) == _shape(want)
    assert got["runs"]
    for path, value in _leaves(got):
        if path and path[-1] in ("f1", "test_f1"):
            assert math.isfinite(value), path
        if "grad_norm_per_step" in path:
            assert math.isfinite(value) and value >= 0, path
    for run in got["runs"].values():
        for stage in (run.values() if sweep == "--union-pretrain" else [run]):
            for trace in stage.get("grad_norm_per_step", {}).values():
                assert len(trace) == 5  # one norm a round (n_steps 5)
