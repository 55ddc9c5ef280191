"""Which of a check's numbers a cell compares: those its workload file
gives a limit."""

from __future__ import annotations

import sys
from typing import Dict


def compared(values: Dict[str, float], limits: Dict) -> Dict:
    """The numbers that the cell's workload file gives a limit, each beside
    it; the others are printed as readings and not compared (a number whose
    control does not read three times its sound runs cannot hold a
    limit)."""
    for name, value in values.items():
        if name not in limits:
            print(f"reading {name} = {value!r} (not compared)",
                  file=sys.stderr)
    return {name: {"value": value, "limit": limits[name]}
            for name, value in values.items() if name in limits}
