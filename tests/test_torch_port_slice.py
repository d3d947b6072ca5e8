"""The port's serving slice end to end at a small size, on the CPU.

Synthetic CSVs -> data prep -> JAX-initialised parameters (through a JAX
checkpoint and ttamm_torch.models.convert) -> port export -> port
RetrievalService -> the HTTP front end. The answers must equal the JAX
package's RetrievalService (numpy backend) over a bundle built from the JAX
``encode_corpus``; the port must also serve that JAX-written bundle; and the
port must run the whole slice without importing JAX or the JAX package.
"""

import json
import os
import subprocess
import sys
import textwrap
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ttamm_torch.pipelines.export import export_bundle, prepare_data
from ttamm_torch.serve import RetrievalService
from ttamm_tpu.data.synthetic import write_synthetic_csvs
from ttamm_tpu.models.two_tower import parse_model_config
from ttamm_tpu.serve import RetrievalService as JaxRetrievalService
from ttamm_tpu.serve import build_flat_index, start_in_thread
from ttamm_tpu.train.checkpoint import save_checkpoint
from ttamm_tpu.train.state import BatchData, create_train_state
from ttamm_tpu.train.step import encode_corpus

REPO = Path(__file__).resolve().parents[1]


def _tower():
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16},
        "fusion": "gated",
    }


def _config(data_dir: Path) -> dict:
    return {
        "experiment": {"seed": 3},
        "data": {
            "root": str(data_dir),
            "books_file": "books.csv",
            "users_file": "users.csv",
            "min_user_interactions": 2,
            "min_item_interactions": 2,
            "feature_params": {"category_top_k": 5, "author_top_k": 4},
        },
        "model": {
            "user_encoder": _tower(),
            "item_encoder": _tower(),
            "similarity": "cosine",
            "adaptive_mimic": {"enabled": True},
        },
    }


@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    write_synthetic_csvs(
        root / "data", num_users=300, num_items=200, num_interactions=4000, seed=3,
    )
    config = _config(root / "data")
    dataset = prepare_data(config)
    nu, ni = len(dataset.user_mapping), len(dataset.item_mapping)
    jcfg = parse_model_config(
        config["model"],
        user_feature_dim=dataset.user_feature_matrix.shape[1],
        item_feature_dim=dataset.item_feature_matrix.shape[1],
    )
    state = create_train_state(jax.random.key(3), jcfg, num_users=nu, num_items=ni)
    ckpt = save_checkpoint(
        root / "ckpt", state, experiment_name="slice", epoch=0, metric_name=None,
        metric_value=None,
    )

    port_dir = root / "port_bundle"
    export_bundle(config, port_dir, device="cpu", checkpoint=ckpt, dataset=dataset)

    # The JAX side's bundle, as pipelines/training.py writes it.
    jax_dir = root / "jax_bundle"
    jax_dir.mkdir()
    data = BatchData(
        user_features=jnp.asarray(dataset.user_feature_matrix),
        item_features=jnp.asarray(dataset.item_feature_matrix),
        positive_rows=jnp.zeros((1, 1), jnp.int32),
        category_ids=None,
    )
    items = np.asarray(encode_corpus(state, data, jcfg, "item", num_rows=ni))
    build_flat_index(items, normalize=True).save(jax_dir / "items.index")
    np.save(jax_dir / "user_embeddings.npy", np.asarray(encode_corpus(state, data, jcfg, "user", num_rows=nu)))
    (jax_dir / "vocab.json").write_text(json.dumps({
        "user_ids": dataset.user_mapping.index_to_id,
        "item_ids": dataset.item_mapping.index_to_id,
        "similarity": "cosine",
    }))
    return root, config, port_dir, jax_dir


def _http(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_port_bundle_matches_jax_bundle(slice_dirs):
    _, _, port_dir, jax_dir = slice_dirs
    for name in ("user_embeddings.npy",):
        np.testing.assert_allclose(
            np.load(port_dir / name), np.load(jax_dir / name), atol=1e-5, rtol=0
        )
    port = RetrievalService.from_artifacts(port_dir, device="cpu")
    ref = JaxRetrievalService.from_artifacts(jax_dir)
    np.testing.assert_allclose(port.index.embeddings, ref.index.embeddings, atol=1e-5, rtol=0)
    assert port.user_ids == ref.user_ids and port.item_ids == ref.item_ids
    assert (port_dir / "items.index").read_bytes()[:24] == (jax_dir / "items.index").read_bytes()[:24]


def test_http_answers_equal_jax_numpy_service(slice_dirs):
    _, _, port_dir, jax_dir = slice_dirs
    port = RetrievalService.from_artifacts(port_dir, device="cpu")
    ref = JaxRetrievalService.from_artifacts(jax_dir)
    srv, thread = start_in_thread(port, port=0)
    try:
        status, body = _http(srv, "/healthz")
        assert status == 200
        assert body == {
            "status": "ok", "users": len(ref.user_ids), "items": len(ref.item_ids),
            "similarity": "cosine",
        }
        for uid in ref.user_ids[:5]:
            want = ref.recommend_for_user(uid, k=10, backend="numpy")
            for status, body in (
                _http(srv, f"/v1/recommend?user_id={uid}&k=10"),
                _http(srv, "/v1/recommend", {"user_id": uid, "k": 10}),
            ):
                assert status == 200
                assert [it["asin"] for it in body["items"]] == [a for a, _ in want]
                np.testing.assert_allclose(
                    [it["score"] for it in body["items"]], [s for _, s in want], atol=1e-5
                )
        emb = ref.user_embeddings[7]
        status, body = _http(srv, "/v1/recommend", {"embedding": emb.tolist(), "k": 6})
        want = ref.recommend_for_embedding(emb, k=6, backend="numpy")
        assert status == 200
        assert [it["asin"] for it in body["items"]] == [a for a, _ in want]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("algorithm", ["group_exact", "fused"])
def test_port_serves_the_jax_bundle(slice_dirs, algorithm):
    _, _, _, jax_dir = slice_dirs
    port = RetrievalService.from_artifacts(jax_dir, device="cpu")
    ref = JaxRetrievalService.from_artifacts(jax_dir)
    for uid in ref.user_ids[10:14]:
        want = ref.recommend_for_user(uid, k=8, backend="numpy")
        got = port.recommend_for_user(uid, k=8)
        assert [a for a, _ in got] == [a for a, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)
    queries = ref.user_embeddings[:16]
    want_s, want_i = ref.index.search(queries, 8, backend="numpy")
    got_s, got_i = port.index.search(queries, 8, algorithm=algorithm)
    if algorithm == "group_exact":
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    else:
        # fused scores bf16-rounded operands (the kernels' semantics)
        np.testing.assert_allclose(got_s, want_s, atol=2e-2)


_NO_JAX_SCRIPT = textwrap.dedent(
    """
    import json, sys, urllib.request
    from ttamm_torch.pipelines.export import main as export_main
    from ttamm_torch.serve.__main__ import main as serve_main
    from ttamm_torch.serve import RetrievalService, start_in_thread

    config, out = sys.argv[1], sys.argv[2]
    export_main(["--config", config, "--out", out, "--device", "cpu"])
    service = RetrievalService.from_artifacts(out, device="cpu")
    serve_main(["--artifacts", out, "--device", "cpu", "--k", "3",
                "--user-id", service.user_ids[0]])
    srv, thread = start_in_thread(service, port=0)
    url = "http://127.0.0.1:%d/v1/recommend?user_id=%s&k=4" % (
        srv.server_address[1], service.user_ids[1])
    with urllib.request.urlopen(url, timeout=30) as resp:
        assert len(json.loads(resp.read())["items"]) == 4
    srv.shutdown()
    srv.server_close()
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ttamm_tpu")))
    assert not leaked, leaked
    print("NO_JAX_OK")
    """
)


def test_port_runs_the_slice_without_jax(slice_dirs):
    root, config, _, _ = slice_dirs
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(cfg_path), str(root / "nojax_bundle")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert '"users":' in proc.stdout  # the export CLI's summary line
