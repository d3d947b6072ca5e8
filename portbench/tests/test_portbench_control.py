"""The controls: the plain reference put in the program's place one
precision below the configuration's must fail a cell's limits, where the
program passes them. The cells' own sizes are read on the card by
``calibrate.py``; these hold the same at sizes a test run can hold."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.drivers import search_batches
from portbench.reference import compare
from portbench.reference import search as reference
from portbench.reference import train_step

from .conftest import BENCH, tiny_root


def _limits(cell: str) -> dict:
    return json.loads((BENCH / "checks" / f"{cell}.json").read_text())["limits"]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


def _search_numbers(rows, queries, scores, ids, k, dtype):
    return reference.numbers(rows, queries, scores, ids, k, dtype)


def _program_search(dtype, items, batch, device, seed=2**31 + 3):
    from ttamm_torch.serve.flat_index import FlatIndex

    rows = search_batches.catalogue(items, 128, seed, device)
    index = FlatIndex(embeddings=rows.cpu().numpy(), normalized=True, score_dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    queries = torch.nn.functional.normalize(torch.randn(batch, 128, generator=gen, device=device), dim=1)
    queries = queries.cpu().numpy()
    scores, ids = index.search(queries, 20)
    return rows, queries, scores, ids


def test_float8_control_fails_the_bf16_search_where_the_program_passes():
    """At 500,000 items the bf16 search routes to the fused kernels' plain
    versions on the CPU, as the 2M cell does to the kernels on the card."""
    limits = _limits("in_batch_softmax.search_2m_bf16")
    rows, queries, scores, ids = _program_search("bfloat16", 500_000, 32, "cpu")
    assert not _fails(_search_numbers(rows, queries, scores, ids, 20, "bfloat16"), limits)
    c_scores, c_ids = reference.control_search(rows, queries, 20, "bfloat16")
    assert _fails(_search_numbers(rows, queries, c_scores, c_ids, 20, "bfloat16"), limits)


@pytest.mark.cuda
def test_tf32_control_fails_the_float32_search_where_the_program_passes(card):
    limits = _limits("default.search_10m_f32")
    rows, queries, scores, ids = _program_search("float32", 600_000, 256, card)
    assert not _fails(_search_numbers(rows, queries, scores, ids, 20, "float32"), limits)
    c_scores, c_ids = reference.control_search(rows, queries, 20, "float32")
    assert _fails(_search_numbers(rows, queries, c_scores, c_ids, 20, "float32"), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["default.train", "in_batch_softmax.train"])
def test_tf32_control_fails_the_training_cell_where_the_program_passes(card, cell, tmp_path, corpus_cache):
    """The program's first three steps on the card (its kernels, as
    replays) against the reference, and the reference in TF32 against it,
    at the tiny corpus with the configuration's widths."""
    from portbench.drivers import train_epochs

    root, bench = tiny_root(tmp_path)
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[cell.split(".")[0]]
    config = json.loads((root / cfg_file).read_text())
    limits = _limits(cell)
    run = train_epochs.Cell(config, {"driver": "train_epochs"}, seed=2**31 + 9, device="cuda",
                            cache=corpus_cache)
    run.setup()
    initial = run._initial()
    batches = run.reference_batches()
    ref = train_step.run(run.cfg, initial, run.data, batches, run.gen_seed)
    assert not _fails(compare.train_numbers(run.readings, ref), limits)
    control = train_step.run(run.cfg, initial, run.data, batches, run.gen_seed, tf32=True)
    assert _fails(compare.train_numbers(control, ref), limits)
    assert np.isfinite(ref["losses"]).all() and weights.stream_seed(run.seed, weights.STEPS) == run.gen_seed
