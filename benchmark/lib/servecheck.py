"""The check of a served scan, step by step from the program's own state
(see ``tap.py``): which steps are checked, and what is compared.

* ``carry_mismatch``: checked steps whose previous-frame input is not, bit
  for bit, the program's own outputs of the two steps before (in its
  compute dtype; zeros before the utterance). Limit 0.
* ``gen_mae`` and ``gen_worst``: the reference generator recomputes each
  checked step from the inputs the program fed it (label context, previous
  frames, first-frame flag); the mean absolute difference of the frames, in
  uint8 levels (x 127.5), over all checked steps and for the worst step.

A cell compares the numbers its workload file gives a limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib.limits import compared
from benchmark.reference.lowp import ieee_f32


def sample_steps(n: int, count: int, rng) -> Tuple[List[int], List[int]]:
    """(checked steps, calls to keep): steps 0, 1, 2 (the start: no previous
    frame, then one) and a seeded rest of the ``n``; kept are those and the
    two steps before each."""
    rest = list(range(3, n))
    extra = rng.choice(rest, min(max(count - 3, 0), len(rest)),
                       replace=False).tolist() if rest else []
    steps = sorted({0, 1, 2, *extra} & set(range(n)))
    keep = sorted({s - k for s in steps for k in (0, 1, 2) if s - k >= 0})
    return steps, keep


def carry_mismatch(calls: Dict, steps: List[int], dtype) -> int:
    bad = 0
    for t in steps:
        prev = calls[t][1]
        want = []
        for k in (1, 2):
            want.append(calls[t - k][3].to(dtype) if t - k >= 0
                        else torch.zeros_like(prev[..., :3]))
        if not torch.equal(prev, torch.cat(want, dim=-1).to(prev.dtype)):
            bad += 1
    return bad


@torch.no_grad()
def step_errors(calls: Dict, steps: List[int], gen, outputs=None
                ) -> List[float]:
    """Per checked step, mean |program frame - reference frame| x 127.5;
    ``outputs`` (step -> frame) replaces the program's frames (the
    control)."""
    errs = []
    with ieee_f32():
        for t in steps:
            labels, prev, has_prev, out = calls[t]
            ref, _, _ = gen(labels.float(), prev.float(), has_prev)
            got = out.float() if outputs is None else outputs[t]
            errs.append(127.5 * float((got - ref).abs().mean()))
    return errs


@torch.no_grad()
def reference_outputs(calls: Dict, steps: List[int], gen) -> Dict:
    with ieee_f32():
        return {t: gen(calls[t][0].float(), calls[t][1].float(),
                       calls[t][2])[0] for t in steps}


def numbers(errs: List[float], carry: int, limits: Dict) -> Dict:
    inf = float("inf")
    return compared({"carry_mismatch": carry,
                     "gen_mae": float(np.mean(errs)) if errs else inf,
                     "gen_worst": float(max(errs)) if errs else inf}, limits)
