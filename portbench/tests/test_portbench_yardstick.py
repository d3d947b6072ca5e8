"""The yardstick's counts against hand counts at two shapes each."""

from __future__ import annotations

import json

import pytest

from portbench import yardstick

from .conftest import REPO


def _config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())["config"]


def test_peaks_are_the_data_sheet():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


@pytest.mark.parametrize("n, d, c, want_bytes, want_flops", [
    # fwd: x 12288*128*4 + ids 12288*4 + M2 64*128*128*4; bwd: M2 + x + dx
    (12288, 128, 64, 6291456 + 49152 + 4194304 + 4194304 + 6291456 + 6291456, 4 * 12288 * 128 * 128),
    (2048, 128, 64, 1048576 + 8192 + 4194304 + 4194304 + 1048576 + 1048576, 4 * 2048 * 128 * 128),
])
def test_moments_counts(n, d, c, want_bytes, want_flops):
    assert yardstick.moments_bytes(n, d, c) == want_bytes
    assert yardstick.moments_flops(n, d) == want_flops


def test_moments_bound_is_the_bytes_at_the_canonical_step():
    ms, by = yardstick.bound_ms(yardstick.moments_bytes(12288, 128, 64), yardstick.moments_flops(12288, 128))
    assert by == "bytes"
    assert ms == pytest.approx(27312128 / 3.35e12 * 1e3)


# A row through one tower at F = 105: 105->256 (forward + weight gradient),
# 256->128, the gate's 256->128 and 128->128 (forward + both gradients).
ROW = 2 * (105 * 256 * 2 + 256 * 128 * 3 + 256 * 128 * 3 + 128 * 128 * 3)


@pytest.mark.parametrize("batch", [2048, 1500])
def test_default_step_flops(batch):
    parts = yardstick.train_step_flops(_config("default"), {"user": 105, "item": 105}, batch)
    rows = batch * (1 + 6 - 1) + batch  # users + positives + 5 negatives each
    assert parts["towers"] == ROW * rows
    assert parts["loss"] == 3 * 2 * batch * 6 * 128
    assert parts["moments"] == 4 * batch * 6 * 128 * 128


@pytest.mark.parametrize("batch", [2048, 1500])
def test_in_batch_step_flops(batch):
    parts = yardstick.train_step_flops(_config("in_batch_softmax"), {"user": 105, "item": 105}, batch)
    assert parts["towers"] == ROW * 2 * batch
    assert parts["loss"] == 3 * 2 * batch * batch * 128
    assert parts["moments"] == 4 * batch * 128 * 128


@pytest.mark.parametrize("b, n, d", [(1024, 10_000_000, 128), (1024, 2_000_000, 128)])
def test_search_flops(b, n, d):
    assert yardstick.search_flops(b, n, d) == 2 * b * n * d


def test_first_layer_takes_no_input_gradient():
    widths = yardstick.linear_widths(105, _config("default")["model"]["user_encoder"])
    assert widths == [(105, 256, False), (256, 128, True), (256, 128, True), (128, 128, True)]
