"""``configs/pod_2x4.yaml`` (the JAX package's pod recipe: in-batch softmax
with sparse mimic tables, owner routing, the bf16 gradient wire and bf16
feature storage) through the port's trainer on the CPU at test widths, and
the export CLI from sharded checkpoint directories.

- One process, the mesh set to 1x1 as the config's header says, two
  epochs with ``checkpointing.sharded: true``: the device feature matrices
  are the JAX package's bf16 arrays bit for bit (compared as uint16); the
  reports, a sharded best checkpoint and the serving bundle are written;
  the export from that directory equals the export from a flat ``.npz`` of
  the same (best) state bit for bit.
- Four gloo ranks at 2x2 (started as torchrun starts them), one epoch: the
  JSON line, a sharded directory with a shard file a rank, the reports,
  and an export from that directory.
- A JAX-written sharded directory (saved from a 2x2 placement) and the JAX
  flat checkpoint of the same state export to the same bundle bit for bit.
- ``mesh.tensor_parallel: true`` at 1x1 trains as the run without it (no
  option is refused any more).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_ranks import launch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.pipelines.export import export_bundle, prepare_data
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.serve import RetrievalService
from ttamm_torch.train import create_train_state
from ttamm_torch.train.checkpoint import save_checkpoint
from ttamm_torch.train.sharded_checkpoint import load_sharded_checkpoint
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.parallel import MeshConfig, build_mesh, pad_state_rows, place_state
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import sharded_checkpoint as jax_sharded
from ttamm_tpu.train import state as jax_state

REPO = Path(__file__).resolve().parents[1]
WORLD, WALL_SECONDS = 4, 240
BUNDLE = ("items.index", "item_embeddings.npy", "user_embeddings.npy", "vocab.json")


def pod_config(root: Path, run: str) -> dict:
    """configs/pod_2x4.yaml at test widths (16-wide towers, a 32-wide
    hidden layer), on the tiny corpus under ``root``, its outputs under
    ``root / run``; every wire option as shipped."""
    config = yaml.safe_load((REPO / "configs" / "pod_2x4.yaml").read_text())
    config["data"].update(root=str(root / "data"), interactions_limit=None,
                          min_user_interactions=2, min_item_interactions=2)
    config["data"]["feature_params"].update(category_top_k=5, author_top_k=4)
    for side in ("user_encoder", "item_encoder"):
        tower = config["model"][side]
        tower["id_embedding"]["params"]["embedding_dim"] = 16
        tower["feature_encoder"].update(hidden_dims=[32], output_dim=16)
        tower["output_dim"] = 16
    out = root / run
    config["training"].update(batch_size=256, num_epochs=2, category_alignment_max_categories=16)
    config["training"]["checkpointing"]["dir"] = str(out / "ckpt")
    config["experiment"]["benchmark_report"] = str(out / "reports" / "benchmark_summary.md")
    config["evaluation"]["faiss"].update(index_path=str(out / "faiss" / "items.index"),
                                         embedding_path=str(out / "faiss" / "item_embeddings.npy"))
    config["diagnostics"].update(
        report_path=str(out / "reports" / "recommendation_report.md"),
        loss_plot_path=str(out / "reports" / "loss_curve.png"),
        embedding_summary_path=str(out / "reports" / "embedding_diagnostics.json"),
    )
    config["logging"]["level"] = "WARNING"
    return config


def _bundle(directory: Path) -> dict:
    out = {name: (directory / name).read_bytes() for name in ("items.index", "vocab.json")}
    out.update({name: np.load(directory / name) for name in BUNDLE if name.endswith(".npy")})
    return out


def _assert_same_bundle(a: Path, b: Path) -> None:
    got, want = _bundle(a), _bundle(b)
    for name in BUNDLE:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            assert got[name] == want[name], name


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pod")
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000, seed=5)
    return root


@pytest.fixture(scope="module")
def one_device(corpus):
    config = pod_config(corpus, "one")
    config["mesh"] = {"data_parallel": 1, "model_parallel": 1}
    config["training"]["checkpointing"]["sharded"] = True
    dataset = prepare_data(config)
    return config, dataset, run_single_experiment(config, device="cpu", dataset=dataset)


def test_pod_recipe_runs_at_1x1(one_device):
    config, dataset, result = one_device
    losses = [result.first_step_loss, *result.train_loss, *result.val_loss, *result.test_loss]
    assert len(result.train_loss) == 2 and np.isfinite(losses).all()
    assert result.step_config.comm_dtype == "bfloat16"
    assert result.step_config.update_routing == "owner"  # read, and unused on one device
    best = result.best_checkpoint_path
    assert best.is_dir() and (best / "manifest.json").is_file()
    assert [p.name for p in best.glob("shards_p*.npz")] == ["shards_p00000.npz"]
    for key in ("report_path", "embedding_summary_path"):
        assert Path(config["diagnostics"][key]).is_file()
    faiss = Path(config["evaluation"]["faiss"]["index_path"]).parent
    assert all((faiss / name).is_file() for name in BUNDLE)


def test_bf16_feature_matrices_are_the_jax_arrays(one_device):
    """The JAX pipeline's ``jnp.asarray(matrix, dtype=bfloat16)`` of the host
    float32 matrices, bit for bit; the dataset itself stays float32."""
    _, dataset, result = one_device
    for name, matrix in (("user_features", dataset.user_feature_matrix),
                         ("item_features", dataset.item_feature_matrix)):
        got = getattr(result.data, name)
        assert matrix.dtype == np.float32 and str(got.dtype) == "torch.bfloat16"
        want = np.asarray(jnp.asarray(matrix, dtype=jnp.bfloat16)).view(np.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want,
                                      err_msg=name)


def test_export_from_the_sharded_directory_equals_the_flat_export(one_device, tmp_path):
    config, dataset, result = one_device
    flat = save_checkpoint(tmp_path / "flat", train_state_to_flat(result.state),
                           experiment_name="pod", epoch=result.best_epoch, metric_name=None,
                           metric_value=None)
    for source, path in (("dir", result.best_checkpoint_path), ("flat", flat)):
        export_bundle(config, tmp_path / source, device="cpu", checkpoint=path, dataset=dataset)
    _assert_same_bundle(tmp_path / "dir", tmp_path / "flat")
    service = RetrievalService.from_artifacts(tmp_path / "dir", device="cpu")
    scores, ids = service.index.search(service.user_embeddings[:8], 5)
    assert ids.shape == (8, 5) and np.isfinite(scores).all()


def test_export_from_a_jax_sharded_directory_equals_its_flat_export(one_device, tmp_path):
    config, dataset, _ = one_device
    jcfg = jax_parse(config["model"], user_feature_dim=dataset.user_feature_matrix.shape[1],
                     item_feature_dim=dataset.item_feature_matrix.shape[1])
    state = jax_state.create_train_state(jax.random.key(4), jcfg, num_users=len(dataset.user_mapping),
                                         num_items=len(dataset.item_mapping))
    names = dict(experiment_name="jax", epoch=1, metric_name=None, metric_value=None)
    flat = jax_ckpt.save_checkpoint(tmp_path / "flat_ckpt", state, **names)
    placed = place_state(build_mesh(MeshConfig(2, 2)), pad_state_rows(jax.device_get(state), 2))
    directory = jax_sharded.save_sharded_checkpoint(tmp_path / "dir_ckpt", placed,
                                                    template="{experiment}_epoch{epoch}", **names)
    assert directory.is_dir()
    for source, path in (("dir", directory), ("flat", flat)):
        export_bundle(config, tmp_path / source, device="cpu", checkpoint=path, dataset=dataset)
    _assert_same_bundle(tmp_path / "dir", tmp_path / "flat")


@pytest.fixture(scope="module")
def mesh_run(corpus):
    config = pod_config(corpus, "mesh")
    config["mesh"] = {"data_parallel": 2, "model_parallel": 2}  # the shipped 2x4, on four ranks
    config["training"]["num_epochs"] = 1
    cfg_path = corpus / "mesh_config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    outputs = launch(
        lambda r: [sys.executable, "-m", "ttamm_torch.train", "--config", str(cfg_path),
                   "--device", "cpu"],
        WORLD, corpus, WALL_SECONDS,
    )
    return config, cfg_path, json.loads(outputs[0].strip().splitlines()[-1])


def test_pod_recipe_runs_on_four_gloo_ranks(mesh_run):
    config, _, summary = mesh_run
    assert summary["experiment"] == "two_tower_pod_2x4" and summary["steps"] > 0
    assert np.isfinite([summary["first_step_loss"], *summary["train_loss"]]).all()
    best = Path(summary["best_checkpoint"])
    assert best.is_dir()  # checkpointing.sharded: auto at four processes
    assert sorted(p.name for p in best.glob("shards_p*.npz")) == [
        f"shards_p{r:05d}.npz" for r in range(WORLD)
    ]
    assert Path(config["diagnostics"]["report_path"]).is_file()


def test_export_cli_reads_the_mesh_runs_directory(mesh_run, tmp_path):
    """``python -m ttamm_torch.pipelines.export --checkpoint <dir>`` in one
    process, every rank's pieces assembled; its bundle equals the export of
    a flat checkpoint of the same state."""
    config, cfg_path, summary = mesh_run
    proc = subprocess.run(
        [sys.executable, "-m", "ttamm_torch.pipelines.export", "--config", str(cfg_path),
         "--out", str(tmp_path / "dir"), "--device", "cpu", "--checkpoint",
         summary["best_checkpoint"]],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["users"] == summary["users"]
    dataset = prepare_data(config)
    cfg = parse_model_config(config["model"], user_feature_dim=dataset.user_feature_matrix.shape[1],
                             item_feature_dim=dataset.item_feature_matrix.shape[1])
    state = create_train_state(cfg, num_users=summary["users"], num_items=summary["items"], seed=0,
                               device="cpu")
    state, _ = load_sharded_checkpoint(summary["best_checkpoint"], state)
    flat = save_checkpoint(tmp_path / "flat_ckpt", train_state_to_flat(state),
                           experiment_name="pod", epoch=1, metric_name=None, metric_value=None)
    export_bundle(copy.deepcopy(config), tmp_path / "flat", device="cpu", checkpoint=flat,
                  dataset=dataset)
    _assert_same_bundle(tmp_path / "dir", tmp_path / "flat")


def test_tensor_parallel_at_one_device_trains_as_without_it(corpus):
    """``mesh.tensor_parallel: true`` at 1x1 (one process) builds no mesh and
    changes nothing, as in the JAX trainer: the same losses and state bit
    for bit as the run without it, and nothing of a shipped config is
    refused (the trainer has no refusal left)."""
    import ttamm_torch.pipelines.training as port_training

    assert not hasattr(port_training, "_refuse_unported")
    states = {}
    for tp in (False, True):
        config = pod_config(corpus, f"tp_{tp}")
        config["mesh"] = {"data_parallel": 1, "model_parallel": 1, "tensor_parallel": tp}
        config["training"].update(num_epochs=1)
        config["training"]["checkpointing"]["enabled"] = False
        result = run_single_experiment(config, device="cpu", max_steps=3)
        assert not result.state.tensor_parallel
        states[tp] = (result.train_loss, train_state_to_flat(result.state))
    assert states[True][0] == states[False][0]
    for key, value in states[True][1].items():
        np.testing.assert_array_equal(value, states[False][1][key], err_msg=key)
