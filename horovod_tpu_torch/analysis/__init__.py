"""hvd-analyze: static and run-time correctness tooling (port of
horovod_tpu/analysis/__init__.py:1-137).

Four cooperating passes:

* :mod:`.program` -- the collective-program signature verifier:
  :func:`verify_program` proves cross-rank agreement of the issued
  collective program on rank 0 *before* any data-plane work, and
  :class:`ProgramTracker` does the same inside the coordinator's
  negotiation (``HVD_TPU_VERIFY_PROGRAM=1``).
* :mod:`.lint` -- the AST lint over the code itself
  (``python -m horovod_tpu_torch.analysis [--strict] [paths]``):
  guarded_by lock discipline, blocking calls under locks,
  rank-conditioned collectives -- plus the stale-waiver audit: a
  ``# lint: ok(...)`` waiver no pass still needs is itself a finding.
* :mod:`.lockorder` -- the run-time lock-order (inversion) detector
  (``HVD_TPU_LOCK_CHECK=1``): the runtime's locks are created through
  its factories; an acquisition closing a cycle in the global lock-order
  graph raises :class:`~.lockorder.LockOrderError`.
* :mod:`.races` -- the Eraser-style lockset data-race detector
  (``HVD_TPU_RACE_CHECK=1``) over the ``# guarded_by:`` fields of the
  runtime's shared classes; the same switch arms :mod:`.threads`'
  role asserts (``# thread: <role>`` contracts).

The reference's fifth pass, ``analysis/donation.py`` (the
donation-lifetime sanitizer and the post-donation-read rule), has no
counterpart: torch has no buffer donation, so a donated-then-read array
cannot occur (ROADMAP.md A, "No counterpart needed").  So the CLI
(``python -m horovod_tpu_torch.analysis``) runs lint, thread-role and
stale-waiver over the given paths, and no post-donation-read pass;
``--strict`` exits 1 on any finding.
"""

from typing import Dict, List

from .lint import Finding, lint_paths, lint_sources  # noqa: F401
from .lockorder import (  # noqa: F401
    CheckedLock,
    CheckedRLock,
    LockOrderError,
    make_lock,
    make_rlock,
)
from .program import (  # noqa: F401
    ProgramRecorder,
    ProgramReport,
    ProgramTracker,
    SignatureEntry,
    collective_source,
    compare_signatures,
    cross_validate,
    record_collective,
    verify_program,
)
from .races import DataRaceError, check_count, race_checked  # noqa: F401
from .threads import ThreadRoleError, require, set_role  # noqa: F401


def analyze_sources(sources: Dict[str, str]) -> List[Finding]:
    """Run every static pass -- lint rules and thread-role -- over one
    shared scan of ``{path: source}``, then audit the waivers: a
    ``# lint: ok(...)`` line no pass used to suppress a finding is
    reported as **stale-waiver**.  (The reference's post-donation-read
    pass is not in the port; see the module docstring.)"""
    from . import lint as _lint
    from . import threads as _threads

    infos = _lint.scan_sources(sources)
    findings = _lint.lint_infos(infos)
    findings += _threads.check_infos(infos)
    for fi in infos.values():
        for line, reason in sorted(fi.waivers.items()):
            if line not in fi.used_waivers:
                findings.append(Finding(
                    fi.path, line, "stale-waiver",
                    f"waiver `# lint: ok({reason})` suppresses nothing "
                    f"— no rule fires on this line any more; delete "
                    f"the waiver so a future regression here cannot "
                    f"hide behind it"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_paths(paths: List[str]) -> List[Finding]:
    from . import lint as _lint

    sources: Dict[str, str] = {}
    for path in _lint._iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                sources[path] = f.read()
        except OSError:
            continue
    return analyze_sources(sources)


def main(argv=None) -> int:
    """CLI: run every static pass over the given paths (default: the
    horovod_tpu_torch package)."""
    import argparse
    import os
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="Static correctness passes: lock discipline, SPMD "
                    "divergence, thread-role contracts, stale waivers.")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to analyze "
                             "(default: the horovod_tpu_torch package)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any finding is reported")
    args = parser.parse_args(argv)
    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    findings = analyze_paths(paths)
    for f in findings:
        print(f.render())
    print(f"hvd-analyze: {len(findings)} finding(s) over "
          f"{', '.join(paths)}", file=sys.stderr)
    if findings and args.strict:
        return 1
    return 0
