"""The port's train step against the JAX train step (see
``test_torch_train.py``) for the variants of the configuration that change
the generator's objective: backprop through the fed-back frames, the mouth
L1 anchor, the VGG term with random filters, and reference-flow
supervision."""

import pytest
import torch

from torch_train_parity import check_variant

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["bptt", "mouth_l1", "random_vgg",
                                     "reference_flow"])
def test_train_step_matches_jax(variant):
    check_variant(variant)
