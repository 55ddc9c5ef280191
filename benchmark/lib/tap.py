"""A tap on the program's generator: while armed, it keeps the inputs and
the output of the steps whose index it was asked for.

The autoregressive scan amplifies rounding: with random weights two
correct computations of the same recurrence, one in bfloat16 and one in
float32 (or even two float32 forms), part by tens of levels within a dozen
frames. So the reference cannot follow the program's frames from the labels
alone; it follows the program step by step from the program's own state:
each checked step is recomputed from the inputs the program fed that step,
and the carry between steps (each step fed the frames the previous steps
produced) is checked by itself, exactly.

How a step is seen. Where the generator offers ``register_step_tap(fn)``,
the tap registers with it, and the program calls
``fn(labels, prev_imgs, has_prev, frame)`` once a generator step, in step
order, however the step runs: a frame loop captured in a CUDA graph hands
its buffers of each replayed step. Otherwise the tap wraps the generator's
``forward(labels, prev_imgs, has_prev)``, which the program's loops call
once a step in Python today.

The copies are made on the device when the step is seen; only the sampled
steps of one request, call or train step are kept.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


class GeneratorTap:
    def __init__(self, gen: torch.nn.Module):
        self.keep: set = set()
        self.calls: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.n = 0
        self.armed = False
        register = getattr(gen, "register_step_tap", None)
        if register is not None:
            register(self.record)
            return
        forward = gen.forward

        def tapped(labels, prev_imgs, has_prev):
            out = forward(labels, prev_imgs, has_prev)
            self.record(labels, prev_imgs, has_prev, out[0])
            return out
        gen.forward = tapped

    def arm(self, keep: Iterable[int]) -> None:
        """Count steps from 0 again and keep those numbered in ``keep``."""
        self.keep, self.calls, self.n, self.armed = set(keep), {}, 0, True

    def disarm(self) -> Dict[int, Tuple[torch.Tensor, ...]]:
        self.armed = False
        return self.calls

    def record(self, labels, prev_imgs, has_prev, frame) -> None:
        if not self.armed:
            return
        if self.n in self.keep:
            self.calls[self.n] = tuple(x.detach().clone() for x in
                                       (labels, prev_imgs, has_prev, frame))
        self.n += 1
