"""The traffic and the weights are made from the seed alone."""
from __future__ import annotations

import torch

from perfbench.lib import seeded, stats

BIG = 2**31 + 17


def test_tokens_weights_and_masks_repeat_for_a_seed():
    m = seeded.lm_dims({"hidden_size": 32, "intermediate_size": 48,
                        "num_attention_heads": 4, "num_key_value_heads": 2,
                        "num_hidden_layers": 2, "vocab_size": 100,
                        "rms_norm_eps": 1e-6, "rope_theta": 1e6,
                        "torch_dtype": "bfloat16"})
    for seed in (BIG, 7):
        a = seeded.token_batches(100, 2, [8, 16], seed, "cpu")
        b = seeded.token_batches(100, 2, [8, 16], seed, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        wa, wb = (seeded.lm_weights(m, seed, "cpu") for _ in range(2))
        assert all(torch.equal(wa[k], wb[k]) for k in wa)
        ma, mb = (seeded.lm_masks(m, 0.5, seed, "cpu") for _ in range(2))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        assert ma["head_mask"].sum(1).tolist() == [2.0, 2.0]
    assert not torch.equal(seeded.token_batches(100, 2, [8], BIG, "cpu")[0],
                           seeded.token_batches(100, 2, [8], 7, "cpu")[0])


def test_leaf_images_repeat_and_cover_the_classes():
    a, la = seeded.leaf_images(10, 32, 4, BIG, "cpu", batch=4)
    b, lb = seeded.leaf_images(10, 32, 4, BIG, "cpu", batch=4)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert a.shape == (10, 32, 32, 3) and 0 <= a.min() and a.max() <= 1
    assert set(la.tolist()) == {0, 1, 2, 3}
    c, _ = seeded.leaf_images(10, 32, 4, BIG + 1, "cpu", batch=4)
    assert not torch.equal(a, c)


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1, 2, 3, 4, 5], 95) == 4.8
    assert stats.percentile([5, 1, 3], 50) == 3
