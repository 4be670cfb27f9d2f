"""Operations and bytes counted once from the shapes, against hand-worked
values."""

import pytest

from portbench import counts


def test_half_step_at_the_flagship_first_layer_is_bound_by_bytes():
    s, by = counts.half_step_bound_s(128, 10000, 1500)
    # 60 MB of W plus x, b, probabilities and samples
    moved = 4 * (128 * 10000 + 10000 * 1500 + 1500 + 2 * 128 * 1500)
    assert by == "bytes"
    assert s == pytest.approx(moved / 3.35e12)
    assert s == pytest.approx(19.90e-6, rel=1e-3)
    assert counts.mm_flops(128, 10000, 1500) / 495e12 == pytest.approx(
        7.758e-6, rel=1e-3)


def test_bimodal_clamped_chain_is_bound_by_operations():
    s, by = counts.chain_bound_s(128, 2500, 1500, 30, False)
    assert by == "operations"
    # 57.6 GFLOP: 30 steps, two products of 2·128·2500·1500 each
    assert s == pytest.approx(57.6e9 / 495e12)


def test_serving_chain_with_its_final_pass():
    s, by = counts.chain_bound_s(128, 532, 500, 50, True, 500)
    assert by == "operations"
    assert s == pytest.approx(51 * 2 * 2 * 128 * 532 * 500 / 495e12)


def test_image_epoch_of_the_flagship():
    # 1 + 2·10 half-steps, 2 statistics products and the next layer's
    # input: 24 products of 2·B·V·H a layer and batch
    per_row = 24 * 2 * (10000 * 1500 + 1500 * 500)
    assert counts.image_epoch_flops([10000, 1500, 500], 10, 1434, 128) \
        == pytest.approx(per_row * 1434)
    assert counts.batch_sizes(1434, 128) == [128] * 11 + [26]
    shapes = counts.image_half_steps([10000, 1500, 500], 10, 1434, 128)
    assert len(shapes) == 12 * 2 * 21
    assert shapes[:12] == [(128, 10000, 1500)] * 11 + [(128, 1500, 10000)]


def test_bimodal_main_epoch():
    mm = counts.mm_flops
    per_batch = lambda B: (  # noqa: E731
        14 * mm(B, 2500, 1500) + 14 * mm(B, 1500, 500)
        + 2 * (60 + 1 + 6 + 1 + 2) * mm(B, 2500, 1500)
        + 2 * 102 * mm(B, 2500, 1500)
        + mm(B, 1500, 1500) + mm(B, 1500, 10000)
        + mm(B, 1000, 500) + mm(B, 500, 500) + mm(B, 500, 1568))
    want = 11 * per_batch(128) + per_batch(26)
    assert counts.bimodal_main_epoch_flops(
        [2500, 1500, 500], [10000, 1500, 1500], [1568, 500, 500, 1000],
        1434, 128, joint_cd=5, init_steps=30, steps=50) \
        == pytest.approx(want)
