"""Back-compat shim (port of ``repro.launch.hlo_analysis``): the program
analysis lives in ``repro_torch.obs.prof``, where the dry run and the
profiling layer share it. Import :func:`repro_torch.obs.prof.analyze_program`
directly in new code.

    PYTHONPATH=src python -m repro_torch.launch.hlo_analysis CELL.program.txt

prints the analysis of a program saved by ``launch.dryrun --save-hlo``.
"""
from __future__ import annotations

from repro_torch.obs.prof import analyze_program, parse_program  # noqa: F401

__all__ = ["analyze_program", "parse_program"]

if __name__ == "__main__":
    import json
    import sys
    with open(sys.argv[1]) as f:
        print(json.dumps(analyze_program(f.read()), indent=1))
