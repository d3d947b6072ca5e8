"""The port's command lines against the JAX package's scripts, and the
trainer's ``diagnostics.profile_dir``, on the CPU.

- ``python -m ttamm_torch.serve.query`` against ``scripts/query.py`` (with
  ``JAX_PLATFORMS=cpu``), both as subprocesses on one TTFLAT index and one
  ``.npy`` of queries, for a float32 and a bf16-header index: under
  ``--backend numpy`` and ``--backend native`` the printed text is equal
  (both search the host float32 rows, whatever the header says); under the
  port's ``--backend device --device cpu`` (``mips_topk`` through the
  kernels' plain versions) the ids equal the JAX numpy search's but where
  the two ids' float32 scores tie within 1e-5, or within 2^-6 for the bf16
  index, whose device search scores bf16 rows (as ``chip_smoke.py``).
- ``python -m ttamm_torch.pipelines.preprocess`` against
  ``scripts/preprocess.py`` on one small synthetic corpus: every array of
  ``training_arrays.npz`` equal bit for bit (the float features too: the
  same host code on the same CSVs), ``vocab.json`` equal as JSON, the
  printed count lines equal.
- ``python -m ttamm_torch.serve --device cpu --backend {numpy,native}``
  against ``scripts/serve.py`` with the same backend on one exported
  bundle: equal lines; the port's ``device`` backend gives the same asins
  but where scores tie within 1e-5; and its HTTP mode under each backend
  answers as the host numpy search does.
- ``run_training`` with ``diagnostics.profile_dir`` writes one Chrome trace
  of the first epoch's train loop; without the key it writes none.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.pipelines.export import export_bundle
from ttamm_torch.pipelines.training import run_training
from ttamm_torch.serve import RetrievalService, build_flat_index

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, JAX_PLATFORMS="cpu")
WALL_SECONDS = 240  # any one subprocess
N_ITEMS, DIM, N_QUERIES, K = 600, 16, 12, 7
TIE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _run(*args: str) -> str:
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=ENV, capture_output=True,
                          text=True, timeout=WALL_SECONDS)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _port(module: str, *args: str) -> str:
    return _run("-m", module, *args)


def _jax(script: str, *args: str) -> str:
    return _run(str(REPO / "scripts" / script), *args)


# ---------------------------------------------------------------------------
# The query CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def query_files(request, tmp_path_factory):
    """A cosine index with a ``score_dtype`` header and its queries."""
    root = tmp_path_factory.mktemp(f"query_{request.param}")
    rng = np.random.default_rng(11)
    emb = rng.normal(0, 1, (N_ITEMS, DIM)).astype(np.float32)
    index = build_flat_index(emb, normalize=True, score_dtype=request.param, device="cpu")
    index.save(root / "items.index")
    np.save(root / "q.npy", rng.normal(0, 1, (N_QUERIES, DIM)).astype(np.float32))
    args = ["--index", str(root / "items.index"), "--queries", str(root / "q.npy"), "--k", str(K)]
    return dict(dtype=request.param, index=index, args=args,
                queries=np.load(root / "q.npy"),
                jax_numpy=_jax("query.py", *args, "--backend", "numpy"))


def _parse(text: str) -> tuple[np.ndarray, np.ndarray]:
    """``query {row}: id:score, ...`` lines -> (ids, scores)."""
    ids, scores = [], []
    for row, line in enumerate(text.strip().splitlines()):
        head, pairs = line.split(": ", 1)
        assert head == f"query {row}"
        items = [p.split(":") for p in pairs.split(", ")]
        ids.append([int(i) for i, _ in items])
        scores.append([float(s) for _, s in items])
    return np.asarray(ids), np.asarray(scores)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_query_cli_prints_what_the_jax_script_prints(query_files, backend):
    got = _port("ttamm_torch.serve.query", *query_files["args"], "--backend", backend,
                "--device", "cpu")
    want = _jax("query.py", *query_files["args"], "--backend", backend)
    assert got == want
    assert got == query_files["jax_numpy"]
    assert len(got.splitlines()) == N_QUERIES


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_query_cli_host_backends_need_no_card(query_files, backend):
    """The host backends load the index on the CPU whatever ``--device``
    says: with the default ``--device cuda`` they answer on a machine
    without a card, and print what ``--device cpu`` prints."""
    got = _port("ttamm_torch.serve.query", *query_files["args"], "--backend", backend)
    assert got == _port("ttamm_torch.serve.query", *query_files["args"], "--backend", backend,
                        "--device", "cpu")


def test_query_cli_device_backend_agrees_but_for_ties(query_files):
    got = _port("ttamm_torch.serve.query", *query_files["args"], "--backend", "device",
                "--device", "cpu")
    ids, _ = _parse(got)
    ref_ids, _ = _parse(query_files["jax_numpy"])
    assert ids.shape == (N_QUERIES, K)
    index = query_files["index"]
    q = query_files["queries"]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    full = q @ index.embeddings.T  # the float32 scores of every item
    got_s = np.take_along_axis(full, ids, 1)
    ref_s = np.take_along_axis(full, ref_ids, 1)
    tol = TIE_TOL[query_files["dtype"]]
    differ = ids != ref_ids
    assert np.all(np.abs(got_s - ref_s)[differ] <= tol), (ids, ref_ids)
    if query_files["dtype"] == "float32":
        assert differ.sum() == 0  # no two scores of this corpus tie


# ---------------------------------------------------------------------------
# Preprocess, the bundle, the serve CLI
# ---------------------------------------------------------------------------


def _tower() -> dict:
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16, "dropout": 0.1},
        "fusion": "gated",
        "output_dim": 16,
    }


def _config(root: Path) -> dict:
    """A tiny corpus under ``root``, configs/default.yaml's structure at
    test widths."""
    return {
        "experiment": {"name": "cli", "seed": 3},
        "data": {
            "root": str(root / "data"), "cache_dir": str(root / "cache"),
            "min_user_interactions": 2, "min_item_interactions": 2,
            "feature_params": {"category_top_k": 5, "author_top_k": 4},
        },
        "model": {"user_encoder": _tower(), "item_encoder": _tower(), "similarity": "cosine",
                  "adaptive_mimic": {"enabled": True}},
        "training": {
            "batch_size": 256, "num_epochs": 1, "learning_rate": 0.01,
            "category_alignment_max_categories": 16,
            "checkpointing": {"enabled": False},
        },
        "evaluation": {
            "metrics_k": [5, 10],
            "faiss": {"index_path": str(root / "run" / "faiss" / "items.index"),
                      "embedding_path": str(root / "run" / "faiss" / "item_embeddings.npy")},
        },
        "diagnostics": {
            "item_sample_size": 20, "user_sample_size": 50, "neighbor_k": 5,
            "report_path": str(root / "run" / "reports" / "recommendation_report.md"),
            "loss_plot_path": str(root / "run" / "reports" / "loss_curve.png"),
            "embedding_summary_path": str(root / "run" / "reports" / "embedding_diagnostics.json"),
        },
        "recommendations": {"sample_users": 2, "top_k": 5},
        "logging": {"level": "WARNING"},
    }


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=5)
    return root


def _write_config(config: dict, path: Path) -> Path:
    import yaml

    path.write_text(yaml.safe_dump(config))
    return path


def test_preprocess_cli_writes_what_the_jax_script_writes(corpus, tmp_path):
    outs = {}
    for side in ("port", "jax"):
        config = _config(corpus)
        config["data"]["cache_dir"] = str(tmp_path / side)
        path = _write_config(config, tmp_path / f"{side}.yaml")
        outs[side] = (_port("ttamm_torch.pipelines.preprocess", "--config", str(path))
                      if side == "port" else _jax("preprocess.py", "--config", str(path)))
    assert outs["port"].splitlines()[:2] == outs["jax"].splitlines()[:2]
    with np.load(tmp_path / "port" / "training_arrays.npz") as got, \
            np.load(tmp_path / "jax" / "training_arrays.npz") as want:
        assert sorted(got.files) == sorted(want.files) == sorted([
            "item_features", "user_features", "positive_rows", "positive_counts", "user_idx",
            "item_idx", "category_ids"])
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["item_features"].size and got["user_idx"].size
    got_vocab = json.loads((tmp_path / "port" / "vocab.json").read_text())
    assert got_vocab == json.loads((tmp_path / "jax" / "vocab.json").read_text())
    assert set(got_vocab) == {"user_ids", "item_ids", "feature_metadata", "category_names"}


@pytest.fixture(scope="module")
def bundle(corpus, tmp_path_factory):
    """A bundle exported by the port from a seeded init of the tiny model."""
    out = tmp_path_factory.mktemp("cli_bundle")
    export_bundle(_config(corpus), out, device="cpu")
    service = RetrievalService.from_artifacts(out, device="cpu")
    return dict(dir=out, service=service, users=service.user_ids[:8])


def _serve_args(bundle, backend: str) -> list[str]:
    args = ["--artifacts", str(bundle["dir"]), "--k", "10", "--backend", backend]
    for uid in [*bundle["users"], "no-such-user"]:
        args += ["--user-id", uid]
    return args


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_serve_cli_prints_what_the_jax_script_prints(bundle, backend):
    got = _port("ttamm_torch.serve", *_serve_args(bundle, backend), "--device", "cpu")
    want = _jax("serve.py", *_serve_args(bundle, backend))
    assert got == want
    lines = got.splitlines()
    assert len(lines) == len(bundle["users"]) + 1 and "\tERROR\t" in lines[-1]


def test_serve_cli_host_backend_needs_no_card(bundle):
    """As the query CLI: ``--backend native`` with the default ``--device
    cuda`` loads the bundle on the CPU."""
    got = _port("ttamm_torch.serve", *_serve_args(bundle, "native"))
    assert got == _port("ttamm_torch.serve", *_serve_args(bundle, "native"), "--device", "cpu")


def _asins(line: str) -> tuple[str, list[str]]:
    uid, pairs = line.split("\t")
    return uid, [p.rsplit(":", 1)[0] for p in pairs.split(", ")]


def test_serve_cli_device_backend_agrees_but_for_ties(bundle):
    got = _port("ttamm_torch.serve", *_serve_args(bundle, "device"), "--device", "cpu")
    want = _port("ttamm_torch.serve", *_serve_args(bundle, "numpy"), "--device", "cpu")
    service = bundle["service"]
    item_pos = {asin: i for i, asin in enumerate(service.item_ids)}
    emb = service.index.embeddings
    for g, w in zip(got.splitlines()[:-1], want.splitlines()[:-1]):
        (uid, g_asins), (_, w_asins) = _asins(g), _asins(w)
        q = service.user_embeddings[service.user_to_idx[uid]]
        q = q / np.linalg.norm(q)
        for a, b in zip(g_asins, w_asins):
            if a != b:
                assert abs(float(emb[item_pos[a]] @ q) - float(emb[item_pos[b]] @ q)) <= 1e-5
    assert got.splitlines()[-1] == want.splitlines()[-1]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(port: int, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def _http_server(bundle, backend: str):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ttamm_torch.serve", "--artifacts", str(bundle["dir"]),
         "--device", "cpu", "--backend", backend, "--http", str(port)],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + WALL_SECONDS
        while True:
            assert proc.poll() is None, proc.communicate()[1][-4000:]
            try:
                _get(port, "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline, "the server did not start"
                time.sleep(0.2)
        yield port
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    assert proc.returncode is not None


@pytest.mark.parametrize("backend", ["device", "native", "numpy"])
def test_serve_cli_http_mode_answers_as_the_host_search(bundle, backend):
    service = bundle["service"]
    uid = bundle["users"][1]
    with _http_server(bundle, backend) as port:
        health = _get(port, "/healthz")
        by_get = _get(port, f"/v1/recommend?user_id={uid}&k=10")
        by_post = _get(port, "/v1/recommend", {"user_id": uid, "k": 10})
        query = service.user_embeddings[service.user_to_idx[uid]]
        by_embedding = _get(port, "/v1/recommend", {"embedding": query.tolist(), "k": 10})
    assert health["items"] == len(service.item_ids)
    want = service.recommend_for_user(uid, k=10, backend="numpy")
    for body in (by_get, by_post, by_embedding):
        got = [(it["asin"], it["score"]) for it in body["items"]]
        assert len(got) == 10
        # the device's asins but where their scores tie within 1e-5
        assert np.allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-5)
        if backend != "device":
            assert got == want  # the host searches' float32 scores, exactly


# ---------------------------------------------------------------------------
# diagnostics.profile_dir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profiled", [True, False])
def test_profile_dir_traces_the_first_train_loop(corpus, tmp_path, profiled):
    config = _config(corpus)
    config["training"].update(num_epochs=2, batch_size=1024)  # a few steps an epoch
    for key in ("report_path", "loss_plot_path", "embedding_summary_path"):
        config["diagnostics"][key] = str(tmp_path / "reports" / Path(config["diagnostics"][key]).name)
    config["evaluation"]["faiss"].update(index_path=str(tmp_path / "faiss" / "items.index"),
                                         embedding_path=str(tmp_path / "faiss" / "e.npy"))
    if profiled:
        config["diagnostics"]["profile_dir"] = str(tmp_path / "profile")
    result = run_training(config, device="cpu")
    assert len(result.train_loss) == 2
    traces = sorted(tmp_path.rglob("*.trace.json"))
    if not profiled:
        assert traces == []
        return
    assert traces == [tmp_path / "profile" / "cli_epoch001.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::addmm", "aten::index_select"} <= names  # the towers, the row reads
