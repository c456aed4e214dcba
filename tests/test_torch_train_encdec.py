"""The encoder-decoder's training cases of ``tests/test_torch_train.py``
and ``tests/test_torch_train_steps.py`` (its loss and gradients, and
three train steps, against the JAX package), in a file of their own so
that another worker runs them: the same checks, shapes, data and tolerances, on the smoke shrink (2 + 2
layers) at 512 frames and tokens (the reference agrees only at multiples
of 512 frames, ``tests/test_torch_encdec.py``)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train import check_loss_and_grads  # noqa: E402
from test_torch_train_steps import check_three_train_steps  # noqa: E402


# K4's non-causal plain version in the encoder and the cross-attention,
# causal in the decoder
@pytest.mark.parametrize("arch,S", [("seamless-m4t-medium", 512)])
def test_loss_and_grads_match_reference(arch, S):
    check_loss_and_grads(arch, S)


@pytest.mark.parametrize("arch,S", [("seamless-m4t-medium", 512)])
def test_three_train_steps_match_reference(arch, S):
    check_three_train_steps(arch, S)
