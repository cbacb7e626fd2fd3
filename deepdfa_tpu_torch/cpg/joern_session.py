"""Interactive Joern session driver.

A copy of ``deepdfa_tpu/cpg/joern_session.py``. It drives a long-lived
``joern`` REPL for batch CPG extraction — one JVM spin-up amortised over
many functions instead of one ``joern --script`` invocation each (the
reference drives the same REPL protocol with pexpect,
``DDFA/sastvd/helpers/joern_session.py:33-121``; here on the stdlib:
subprocess pipes + a reader thread, prompt-synchronised commands, ANSI
stripping, typed parameter marshalling, per-worker workspaces).

If the ``joern`` binary is absent, :class:`JoernSession` raises at spawn;
the native front end (:mod:`deepdfa_tpu_torch.cpg.frontend`) needs none.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from deepdfa_tpu_torch.resilience import faults

__all__ = [
    "JoernSession",
    "JoernTimeout",
    "strip_ansi",
    "marshal_params",
    "joern_available",
]

_ANSI_RE = re.compile(
    r"\x1b(?:[@-Z\\-_]|\[[0-?]*[ -/]*[@-~])"  # 7-bit C1: ESC + CSI sequences
)

PROMPT = "joern>"
SCRIPT_DIR = Path(__file__).parent / "queries"


def strip_ansi(text: str) -> str:
    """Remove ANSI escape sequences (the REPL colors its prompt even under
    ``--nocolors`` on some terminals)."""
    return _ANSI_RE.sub("", text)


class JoernTimeout(TimeoutError):
    """No prompt within the deadline. ``partial`` carries the full
    ANSI-stripped buffer accumulated so far (the message keeps only the
    tail) — the extraction supervisor logs it so quarantine entries say
    *why* a function hung, not just that it did."""

    def __init__(self, message: str, partial: str = ""):
        super().__init__(message)
        self.partial = partial


def _scala_str(val: str | Path) -> str:
    """A quoted Scala string literal with escaping — paths can contain
    quotes/backslashes and must not break out of the literal."""
    escaped = str(val).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{escaped}"'


def marshal_params(params: dict) -> str:
    """Render ``exec(...)`` arguments with Scala literal syntax: strings and
    paths quoted (WITH escaping — file paths can contain quotes), bools
    lowercased, ints/floats bare."""
    parts = []
    for key, val in params.items():
        if isinstance(val, bool):
            rendered = str(val).lower()
        elif isinstance(val, (int, float)):
            rendered = str(val)
        elif isinstance(val, (str, Path)):
            rendered = _scala_str(val)
        else:
            raise TypeError(f"cannot marshal {key}={val!r} ({type(val).__name__})")
        parts.append(f"{key}={rendered}")
    return ", ".join(parts)


def joern_available(joern_bin: str = "joern") -> bool:
    return shutil.which(joern_bin) is not None


class JoernSession:
    """One interactive ``joern`` REPL.

    ``worker_id > 0`` switches into a private ``workers/{id}`` workspace so
    parallel sessions don't clobber each other's projects (the reference's
    per-worker workspace scheme)."""

    def __init__(
        self,
        worker_id: int = 0,
        joern_bin: str = "joern",
        cwd: str | Path | None = None,
        timeout: float = 600.0,
        clean: bool = False,
    ):
        if not joern_available(joern_bin):
            raise RuntimeError(
                f"joern binary {joern_bin!r} not on PATH — use the native "
                "frontend (deepdfa_tpu_torch.cpg.frontend) instead"
            )
        self.timeout = timeout
        self.cwd = Path(cwd) if cwd is not None else Path.cwd()
        workspace = "workspace" if worker_id == 0 else f"workers/{worker_id}"
        if clean:  # must happen BEFORE the REPL starts and switches into it
            ws = self.cwd / workspace
            if ws.exists():
                shutil.rmtree(ws)
        self.proc = subprocess.Popen(
            [joern_bin, "--nocolors"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=self.cwd,
            text=True,
            bufsize=0,
        )
        self._buf: list[str] = []
        self._cond = threading.Condition()
        self._eof = False
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()
        self.read_until_prompt()
        if worker_id != 0:
            self.switch_workspace(workspace)

    # -- low-level protocol -------------------------------------------------
    def _pump(self) -> None:
        try:
            while True:
                chunk = self.proc.stdout.read(1)
                if not chunk:
                    break
                with self._cond:
                    self._buf.append(chunk)
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._eof = True
                self._cond.notify_all()

    def read_until_prompt(self, timeout: float | None = None) -> str:
        """Block until the REPL prints its prompt; return (and consume) the
        output before it, ANSI-stripped."""
        deadline = time.monotonic() + (timeout if timeout is not None else self.timeout)
        with self._cond:
            while True:
                text = "".join(self._buf)
                idx = text.find(PROMPT)
                if idx >= 0:
                    del self._buf[:]
                    rest = text[idx + len(PROMPT):]
                    if rest:
                        self._buf.append(rest)
                    return strip_ansi(text[:idx]).replace("\r", "").strip()
                if self._eof:
                    raise RuntimeError(
                        "joern REPL exited unexpectedly:\n" + strip_ansi(text)
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    buffered = strip_ansi(text)
                    raise JoernTimeout(
                        f"no joern prompt within {timeout or self.timeout}s; "
                        f"buffered: {buffered[-500:]!r}",
                        partial=buffered,
                    )
                self._cond.wait(min(remaining, 1.0))

    def run_command(self, command: str, timeout: float | None = None) -> str:
        # chaos points: a JVM that dies under a command, and one that eats
        # the command whole (no output, no prompt → timeout path)
        if faults.fire("joern.die"):
            self.proc.kill()
        elif not faults.fire("joern.hang"):
            self.proc.stdin.write(command + "\n")
            self.proc.stdin.flush()
        return self.read_until_prompt(timeout=timeout)

    # -- joern commands -----------------------------------------------------
    def run_script(
        self,
        script: str,
        params: dict,
        script_dir: str | Path = SCRIPT_DIR,
        timeout: float | None = None,
    ) -> str:
        """Import ``{script}.sc`` from ``script_dir`` and call its ``exec``
        entry point with marshalled parameters.

        Ammonite ``$file`` imports are cwd-relative and dotted, so scripts
        outside the session cwd are staged into ``deepdfa_joern_scripts/``
        first. Every path segment must be a valid Scala identifier — a
        dotted/hidden directory name would render as ``import $file..foo``
        and fail to parse (the reference's ``storage.external`` import obeys
        the same constraint, ``joern_session.py:81-86``).
        """
        src = Path(script_dir) / f"{script}.sc"
        if not src.exists():
            raise FileNotFoundError(src)
        try:
            rel = src.resolve().relative_to(self.cwd.resolve())
        except ValueError:
            stage = self.cwd / "deepdfa_joern_scripts"
            stage.mkdir(exist_ok=True)
            shutil.copyfile(src, stage / src.name)
            rel = Path("deepdfa_joern_scripts") / src.name
        dotted = ".".join(rel.with_suffix("").parts)
        if not all(re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", p)
                   for p in rel.with_suffix("").parts):
            raise ValueError(
                f"script path {rel} has segments that are not valid Scala "
                "identifiers — Ammonite $file imports cannot express it"
            )
        self.run_command(f"import $file.{dotted}")
        return self.run_command(
            f"{script}.exec({marshal_params(params)})", timeout=timeout
        )

    def switch_workspace(self, path: str) -> str:
        return self.run_command(f"switchWorkspace({_scala_str(path)})")

    def import_code(self, filepath: str | Path) -> str:
        return self.run_command(f"importCode({_scala_str(filepath)})")

    def import_cpg(self, filepath: str | Path) -> str:
        """Prefer the saved ``.cpg.bin`` next to the file; fall back to
        importing the source and saving the binary for next time."""
        bin_path = Path(str(filepath) + ".cpg.bin")
        if bin_path.exists():
            return self.run_command(f"importCpg({_scala_str(bin_path)})")
        out = self.import_code(filepath)
        try:
            shutil.copyfile(self.cpg_path(), bin_path)
        except OSError:
            pass
        return out

    def delete_project(self) -> str:
        return self.run_command("delete")

    def list_workspace(self) -> str:
        return self.run_command("workspace")

    def cpg_path(self) -> Path:
        project_path = self.run_command("print(project.path)")
        return Path(project_path.strip().splitlines()[-1]) / "cpg.bin"

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        try:
            self.proc.stdin.write("exit\n")
            self.proc.stdin.flush()
            self.proc.stdin.write("y\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait(timeout=10)

    def __enter__(self) -> "JoernSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
