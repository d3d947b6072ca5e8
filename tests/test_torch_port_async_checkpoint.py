"""``checkpointing.async_save``: the port's ``AsyncCheckpointer`` on the CPU.

- An async save's files equal a synchronous save's (every array bit for
  bit, the meta but its ``timestamp``), in the flat and the sharded format,
  on one process and on four gloo ranks (as tests/torch_ranks.py starts
  them; the worker saves as the trainer does: the sharded pieces from a
  device clone, the flat arrays gathered on the main thread).
- A state changed in place by a train step right after ``submit`` (the
  sparse tables and their moments by sparse-row Adam): the file holds the
  values from before, from the trainer's snapshot (``copy.deepcopy``).
- Writes to one file stay in submit order; a worker's error is raised by
  ``wait()``.
- The trainer with ``async_save: true`` writes the files of ``false``.
- ``write_npz`` (both writers' file format) gives ``np.savez``'s members
  byte for byte, C-, Fortran- and non-contiguous, 0-d and empty arrays.

The card's pull (the writer's stream, pinned buffers) is held to the
synchronous save by ``chip_smoke.py``'s A/B.
"""

import copy
import io
import json
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_trainer import _config
from torch_ranks import launch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train import checkpoint as ckpt
from ttamm_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint, write_npz
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_torch.train.sharded_checkpoint import MANIFEST, save_sharded_checkpoint

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
NU, NI, FU, FI, D = 50, 40, 6, 5, 16
NAMES = dict(experiment_name="port", epoch=2, metric_name="recall@10", metric_value=0.125,
             template="{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt")


def _model_yaml() -> dict:
    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [8], "output_dim": D, "dropout": 0.0},
        "fusion": "gated",
    }
    return {"user_encoder": tower, "item_encoder": dict(tower), "similarity": "cosine",
            "adaptive_mimic": {"enabled": True, "sparse": True}}


def _setup(device="cpu"):
    """A state after two BCE steps (every moment non-zero somewhere), its
    data and step."""
    cfg = parse_model_config(_model_yaml(), user_feature_dim=FU, item_feature_dim=FI)
    rng = np.random.default_rng(0)
    pos = np.full((NU, 3), NI, np.int32)
    pos[:, 0] = rng.integers(0, NI, NU)
    data = BatchData(
        torch.from_numpy(rng.normal(0, 1, (NU, FU)).astype(np.float32)).to(device),
        torch.from_numpy(rng.normal(0, 1, (NI, FI)).astype(np.float32)).to(device),
        torch.from_numpy(pos).to(device),
        torch.from_numpy(rng.integers(0, 4, NI).astype(np.int32)).to(device),
    )
    tscfg = TrainStepConfig(num_items=NI, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
                            lambda_category_alignment=0.01, cal_max_categories=8,
                            opt=DenseOptConfig(name="adamw", lr=1e-2, weight_decay=0.01))
    state = create_train_state(cfg, num_users=NU, num_items=NI, seed=0, device=device)
    step = make_train_step(cfg, tscfg)
    gen = torch.Generator(device=device).manual_seed(1)

    def run(state):
        u = torch.from_numpy(rng.integers(0, NU, 16).astype(np.int32)).to(device)
        return step(state, data, u, data.positive_rows[u.long(), 0].contiguous(), generator=gen)[0]

    for _ in range(2):
        state = run(state)
    return state, run


def _arrays(path: Path) -> dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as blob:
        return {k: blob[k] for k in blob.files}


def _meta(raw) -> dict:
    meta = json.loads(raw if isinstance(raw, str) else bytes(raw).decode("utf-8"))
    assert meta.pop("timestamp") > 0
    return meta


def assert_same_flat(got: Path, want: Path) -> None:
    a, b = _arrays(got), _arrays(want)
    assert list(a) == list(b)  # the same leaves, in the same order
    assert _meta(a.pop("__meta__")) == _meta(b.pop("__meta__"))
    for key in b:
        assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


def assert_same_sharded(got: Path, want: Path) -> None:
    shards = sorted(p.name for p in want.glob("shards_p*.npz"))
    assert shards and sorted(p.name for p in got.glob("shards_p*.npz")) == shards
    assert _meta((got / MANIFEST).read_text()) == _meta((want / MANIFEST).read_text())
    for name in shards:
        a, b = _arrays(got / name), _arrays(want / name)
        assert list(a) == list(b)
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("sharded", [False, True])
def test_async_files_equal_the_synchronous_ones(tmp_path, sharded):
    state, _ = _setup()
    writer = AsyncCheckpointer(sharded=sharded)
    if sharded:
        want = save_sharded_checkpoint(tmp_path / "sync", state, **NAMES)
    else:
        want = save_checkpoint(tmp_path / "sync", state, **NAMES)
    [got] = writer.submit(copy.deepcopy(state), [dict(directory=tmp_path / "async", **NAMES)])
    writer.wait()
    assert got.name == want.name
    (assert_same_sharded if sharded else assert_same_flat)(got, want)


def test_a_state_changed_after_submit_is_saved_as_it_was(tmp_path, monkeypatch):
    """The write is held back until a train step has updated the live state
    in place; the file holds the state at submit time."""
    state, run = _setup()
    before = {k: np.array(v) for k, v in train_state_to_flat(state).items()}  # copies
    release, started = threading.Event(), threading.Event()
    save = ckpt.save_checkpoint

    def held(*args, **kwargs):
        started.set()
        assert release.wait(30)
        return save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    writer = AsyncCheckpointer()
    [path] = writer.submit(copy.deepcopy(state), [dict(directory=tmp_path, **NAMES)])
    assert started.wait(30)
    state = run(state)  # sparse-row Adam writes the tables and moments in place
    after = train_state_to_flat(state)
    changed = [k for k in before if not np.array_equal(before[k], after[k])]
    assert {"tables/item_id", "opt_sparse/item_id/m", "tables/user_aug", "step"} <= set(changed)
    release.set()
    writer.wait()
    saved = _arrays(path)
    for key, value in before.items():
        assert saved[key].tobytes() == np.asarray(value).tobytes(), key


def test_writes_stay_in_order_and_an_error_surfaces_at_wait(tmp_path):
    state, run = _setup()
    writer = AsyncCheckpointer()
    last = dict(NAMES, template="{experiment}_last.pt")
    writer.submit(copy.deepcopy(state), [dict(directory=tmp_path, **dict(last, epoch=1))])
    later = run(state)
    writer.submit(copy.deepcopy(later), [dict(directory=tmp_path, **dict(last, epoch=2))])
    writer.wait()
    saved = _arrays(tmp_path / "port_last.pt")
    assert _meta(saved["__meta__"])["epoch"] == 2
    assert saved["tables/item_id"].tobytes() == train_state_to_flat(later)["tables/item_id"].tobytes()

    blocked = tmp_path / "a_file"
    blocked.write_text("not a directory")
    writer.submit(copy.deepcopy(state), [dict(directory=blocked / "ckpt", **NAMES)])
    with pytest.raises(RuntimeError, match="Async checkpoint save failed") as info:
        writer.wait()
    assert isinstance(info.value.__cause__, OSError)


def test_four_gloo_ranks_write_the_synchronous_files(tmp_path):
    state, _ = _setup()
    flat = train_state_to_flat(state)
    np.savez(tmp_path / "inputs.npz", **{f"state/{k}": v for k, v in flat.items()})
    task = dict(kind="async_checkpoint", name="async_checkpoint", mesh=[2, 2],
                model=_model_yaml(), feature_dims=[FU, FI], num_users=NU, num_items=NI,
                state="state", save_dir=str(tmp_path / "saved"))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path),
                                "tasks": [task]}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], 4, tmp_path, 120)
    saved = tmp_path / "saved"
    assert_same_sharded(saved / "async_sharded" / "port_last.pt", saved / "sync_sharded" / "port_last.pt")
    assert_same_flat(saved / "async_flat" / "port_last.pt", saved / "sync_flat" / "port_last.pt")
    # the gathered flat file is the state the ranks were given
    got = _arrays(saved / "async_flat" / "port_last.pt")
    for key, value in flat.items():
        assert got[key].tobytes() == np.asarray(value).tobytes(), key


def test_the_trainer_writes_the_synchronous_files_in_the_background(tmp_path):
    write_synthetic_csvs(tmp_path / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=3)
    results = {}
    for mode in (False, True):
        config = _config(tmp_path / str(mode))
        config["data"]["root"] = str(tmp_path / "data")
        for side in ("user_encoder", "item_encoder"):
            config["model"][side]["feature_encoder"]["dropout"] = 0.0
        config["training"]["checkpointing"].update(async_save=mode, save_best_only=False)
        results[mode] = run_single_experiment(config, device="cpu")
    sync, background = results[False], results[True]
    assert background.checkpoint_wait_seconds >= 0.0 and sync.checkpoint_wait_seconds == 0.0
    files = sorted(p.name for p in sync.checkpoint_path.parent.iterdir())
    assert len(files) >= 3 and sorted(p.name for p in background.checkpoint_path.parent.iterdir()) == files
    for name in files:
        assert_same_flat(background.checkpoint_path.parent / name, sync.checkpoint_path.parent / name)



def test_write_npz_gives_the_members_of_np_savez():
    grid = np.arange(24, dtype=np.float64).reshape(4, 6)
    arrays = {
        "c": np.arange(12, dtype=np.float32).reshape(3, 4), "scalar": np.asarray(7, np.int32),
        "empty": np.zeros((0, 5), np.float32), "meta": np.frombuffer(b'{"epoch": 1}', np.uint8),
        "fortran": grid.T, "strided": grid[:, ::2], "flags": np.array([True, False]),
    }
    want, got = io.BytesIO(), io.BytesIO()
    np.savez(want, **arrays)
    write_npz(got, arrays)
    a, b = (zipfile.ZipFile(io.BytesIO(f.getvalue())) for f in (want, got))
    assert a.namelist() == b.namelist() == [f"{k}.npy" for k in arrays]
    for name in a.namelist():
        assert a.read(name) == b.read(name), name
    with np.load(io.BytesIO(got.getvalue())) as blob:
        for key, value in arrays.items():
            np.testing.assert_array_equal(blob[key], value)
