"""The PyTorch port and chip_smoke.py import nothing of JAX, nothing of the
JAX package, no pandas, no sklearn and no transformers at module level:
every module imports in a fresh interpreter where ``jax``, ``flax``,
``optax``, ``pandas``, ``sklearn`` and ``transformers`` are poisoned and
``deepdfa_tpu`` is blocked, and no port file names the first five or the
JAX package in an import statement (``transformers`` only inside the
functions that load an HF tokenizer). (A subprocess, because this pytest
process has already imported JAX.)"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deepdfa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn",
             "deepdfa_tpu")
# every module of the port (the C front end, the encode pipeline, scan,
# the corpus side, preprocess, predict, the dataset readers and their table
# layer, Joern ingestion and its session, the HTTP service, the cascade,
# the telemetry plane, the registered ops, the exported artifacts, the warm
# store, the trainer's command line, its resilience layer, the training
# telemetry, the int8 training experiment, the tuning loop, the dataflow
# experiment, the perf ledger, the fleet router, the replica launcher,
# the continual loop, admission control, the federation, generation, the
# self-instruct data, RoBERTa, the finetune_llm, train_joint and
# performance_evaluation entry points, the kernels' FLOP formulas, the
# profiler and the sharded LLM's collectives included) and chip_smoke.py
N_MODULES = 115


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn",
                     "transformers"):
            sys.modules[name] = None

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "deepdfa_tpu" or name.startswith("deepdfa_tpu."):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        import deepdfa_tpu_torch
        names = ["chip_smoke"] + [
            m.name for m in pkgutil.walk_packages(
                deepdfa_tpu_torch.__path__, "deepdfa_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(n for n in sys.modules if sys.modules[n] is not None and
                     (n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                          "pandas", "sklearn", "transformers",
                                          "deepdfa_tpu")))
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= N_MODULES


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                          if _forbidden(n)]
    assert offenders == []


def test_prefix_check_tells_the_port_from_the_jax_package():
    assert _forbidden("deepdfa_tpu") and _forbidden("deepdfa_tpu.ops.segment")
    assert _forbidden("pandas") and _forbidden("pandas.core.frame")
    assert not _forbidden("deepdfa_tpu_torch")
    assert not _forbidden("deepdfa_tpu_torch.ops.fused_ggnn")
