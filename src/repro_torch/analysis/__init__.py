"""Correctness tooling for the storage plane: the knob registry and the
runtime happens-before sanitizer (the port's copies of the reference's
``repro.analysis.knobs`` and ``repro.analysis.sanitizer``).

This package must stay importable with zero side effects and zero imports
from ``core``: core imports :mod:`.knobs` / :mod:`.sanitizer` at module
load.
"""

from . import knobs, sanitizer  # noqa: F401

__all__ = ["knobs", "sanitizer"]
