"""The C front end and the code-property-graph analyses (host side).

A copy of the JAX package's ``deepdfa_tpu/cpg`` modules that the encode
pipeline and ``scan`` run (standard library, numpy and pycparser):

- :mod:`~deepdfa_tpu_torch.cpg.schema` — the columnar CPG container;
- :mod:`~deepdfa_tpu_torch.cpg.frontend` — C source → Joern-shaped CPG
  through pycparser, no JVM;
- :mod:`~deepdfa_tpu_torch.cpg.analyses` and
  :mod:`~deepdfa_tpu_torch.cpg.dataflow` — the gen/kill dataflow
  framework with its three solvers (Python sets, numpy bit matrix, the
  C++ worklist of ``native/dfa_solver.cpp`` built by the host compiler);
- :mod:`~deepdfa_tpu_torch.cpg.features` — abstract-dataflow features and
  the dependence-edge pass;
- :mod:`~deepdfa_tpu_torch.cpg.callgraph` and
  :mod:`~deepdfa_tpu_torch.cpg.interproc` — the call graph, the
  interprocedural supergraph and its taint analyses;
- :mod:`~deepdfa_tpu_torch.cpg.validate` — the structural validator;
- :mod:`~deepdfa_tpu_torch.cpg.ivdetect` — per-statement features and the
  statement labels;
- :mod:`~deepdfa_tpu_torch.cpg.plot` — DOT text;
- :mod:`~deepdfa_tpu_torch.cpg.joern` and
  :mod:`~deepdfa_tpu_torch.cpg.joern_session` — Joern's exported
  artifacts read into a CPG, and the interactive Joern REPL driver (with
  the query scripts of ``cpg/queries/``).
"""

from deepdfa_tpu_torch.cpg.schema import CPG  # noqa: F401
