"""Three SGD steps of the port's siamese net with the backbone unfrozen,
against the JAX package's: ``densenet-tiny`` at 32 px, batch 4, f32,
dropout 0, lr 1e-4, the pair-based self-supervised circle loss (the chip
recipe's), the same weights, batches and augmentation draws; each step from
the JAX state after the one before. The helpers and tolerances are
tests/test_torch_port_siamese_train.py's (a file of its own to keep each
file's JAX compiles within 30 s on one process).
"""

import pytest
import torch
from test_torch_port_siamese_train import test_three_sgd_steps_match_jax as three_steps


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    from test_torch_port_siamese_train import cards as make_cards

    return make_cards.__wrapped__(tmp_path_factory)


def test_three_sgd_steps_unfrozen_match_jax(cards):
    three_steps(cards, frozen=False, loss="self_supervised_circle")
