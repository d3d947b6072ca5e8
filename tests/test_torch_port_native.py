"""The port's ``native`` search backend against the JAX package's.

``ttamm_torch/serve/native_bridge.py`` builds ``ttamm_torch/csrc/host/
flat_index.cpp`` (``native/flat_index.cpp`` byte for byte) with
``native/Makefile``'s code-generation flags, so ids and scores equal JAX's
``native_flat_search`` bit for bit, ties included (the library
``tests/conftest.py`` builds from ``native/``). The ids also equal the
port's ``numpy`` backend. Without a compiler, or when the build fails, a
native search raises instead of answering from numpy. Skipped only where no
``g++`` exists, as ``tests/conftest.py`` skips the JAX build.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from ttamm_torch.ops import kernels
from ttamm_torch.serve import build_flat_index
from ttamm_torch.serve import native_bridge
from ttamm_tpu.serve import native_flat_search as jax_native_flat_search

REPO = Path(__file__).resolve().parents[1]
N, D, B, K = 2000, 32, 16, 9  # tests/test_serve.py's corpus


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native searcher cannot be built")


def _corpus(kind: str):
    rng = np.random.default_rng(2)
    emb = rng.normal(0, 1, (N, D)).astype(np.float32)
    queries = rng.normal(0, 1, (B, D)).astype(np.float32)
    if kind == "ties":
        # every row four times over: each score ties with three others
        emb = np.repeat(emb[: N // 4], 4, axis=0)
    return emb, queries


def test_source_is_the_jax_packages():
    assert (REPO / "ttamm_torch/csrc/host/flat_index.cpp").read_bytes() == (
        REPO / "native/flat_index.cpp").read_bytes()


@pytest.mark.parametrize("kind", ["plain", "ties", "normalized"])
def test_native_backend_matches_jax_native(kind):
    emb, queries = _corpus(kind)
    index = build_flat_index(emb, normalize=kind == "normalized", device="cpu")
    scores, ids = index.search(queries, K, backend="native")
    # the JAX searcher on the index's rows and the queries normalised as the
    # JAX FlatIndex does before its native call
    q = queries
    if kind == "normalized":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    want = jax_native_flat_search(index.embeddings, q, K)
    assert want is not None, "tests/conftest.py did not build native/libttamm_native.so"
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_array_equal(scores, want[0])
    assert scores.dtype == np.float32 and ids.dtype == np.int64
    ref_scores, ref_ids = index.search(queries, K, backend="numpy")
    if kind == "ties":
        # numpy's order among equal scores is its own: the same score
        # multiset a row, each id with its row's score
        np.testing.assert_allclose(np.sort(scores, 1), np.sort(ref_scores, 1), rtol=0, atol=1e-5)
        full = q @ index.embeddings.T
        np.testing.assert_allclose(np.take_along_axis(full, ids, 1), scores, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-4)


def test_native_raises_without_a_compiler(monkeypatch, tmp_path):
    emb, queries = _corpus("plain")
    index = build_flat_index(emb, device="cpu")
    monkeypatch.setattr(native_bridge, "_lib", None)
    monkeypatch.setattr(native_bridge, "find_cxx", lambda: None)
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        index.search(queries, K, backend="native")
    assert not list(tmp_path.iterdir())


def test_native_raises_with_the_compilers_error(monkeypatch, tmp_path):
    broken = tmp_path / "flat_index.cpp"
    broken.write_text("int ttamm_flat_topk( {\n")
    monkeypatch.setattr(native_bridge, "_SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native_bridge.build_native_library(tmp_path / "build")
    assert "error" in str(err.value)  # the compiler's stderr, quoted


def test_native_rejects_mismatched_queries():
    emb, queries = _corpus("plain")
    with pytest.raises(ValueError, match="do not match"):
        native_bridge.native_flat_search(emb, queries[:, :-1], K)
    with pytest.raises(RuntimeError, match="code 3"):  # k > n
        native_bridge.native_flat_search(emb[:4], queries, K)
