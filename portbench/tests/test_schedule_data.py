"""Seeded inputs repeat: the same seed gives the same schedule, images,
weights and rows, and every seed gets the same amount of work."""

import numpy as np
import pytest
import torch

from portbench import data, schedule

MIX = {"arrivals": "poisson", "rate_per_s": 500.0}
BIG_SEED = 2 ** 31 + 12345


def test_the_schedule_repeats_and_every_seed_gets_the_same_count():
    a = schedule.open_loop(MIX, 4.0, 512, BIG_SEED)
    b = schedule.open_loop(MIX, 4.0, 512, BIG_SEED)
    c = schedule.open_loop(MIX, 4.0, 512, BIG_SEED + 1)
    assert np.array_equal(a.due_s, b.due_s) and np.array_equal(a.item, b.item)
    assert len(a.due_s) == len(c.due_s) == 2000
    assert not np.array_equal(a.due_s, c.due_s)
    assert np.all(np.diff(a.due_s) >= 0) and 0 <= a.due_s[0] and a.due_s[-1] < 4.0


def test_an_unknown_arrival_process_is_refused():
    with pytest.raises(ValueError, match="unknown arrivals"):
        schedule.open_loop({**MIX, "arrivals": "onoff"}, 4.0, 8, 3)


def test_samples_repeat_and_are_distinct():
    a = schedule.sample(1000, 64, BIG_SEED)
    assert np.array_equal(a, schedule.sample(1000, 64, BIG_SEED))
    assert len(set(a.tolist())) == 64
    assert len(schedule.sample(10, 64, 1)) == 10


def test_images_weights_and_rows_repeat():
    assert torch.equal(data.images(BIG_SEED, 3, 32, "cpu"), data.images(BIG_SEED, 3, 32, "cpu"))
    assert not torch.equal(data.images(1, 3, 32, "cpu"), data.images(2, 3, 32, "cpu"))
    w1, w2 = data.resnet50_weights(BIG_SEED, "cpu"), data.resnet50_weights(BIG_SEED, "cpu")
    assert all(torch.equal(w1[k], w2[k]) and w1[k].dtype == torch.bfloat16 for k in w1)
    anchors = torch.randn(4, 16)
    r1 = data.near_dup_rows(anchors, 70000, BIG_SEED, (0.05, 1.0))
    blocks = torch.cat([b for _, b in data.near_dup_blocks(anchors, 70000, BIG_SEED, (0.05, 1.0))])
    assert torch.equal(r1, blocks) and r1.shape == (70000, 16)


def test_streams_of_one_seed_are_independent():
    assert data.subseed(7, data.WEIGHTS) != data.subseed(7, data.IMAGES)
    assert 0 <= data.subseed(-3, data.ROWS, 5) < 2 ** 63
