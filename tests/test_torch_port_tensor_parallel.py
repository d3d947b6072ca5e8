"""``mesh.tensor_parallel`` in the port against the JAX package, on the CPU.

With tensor parallelism the dense tower layers (the feature MLPs and the
σ-gates) and their AdamW moments are split over the ``model`` axis in
Megatron column / row slices (``ttamm_torch/parallel/sharding.py``,
``ttamm_torch/models/encoders.py``). The ranks (tests/torch_parallel_worker.py,
four gloo processes) start once for the whole module and run every
scenario; the JAX side runs here on its virtual 8-device CPU mesh, its
row updates on the XLA path (``use_pallas=False``: interpret-mode Pallas
rows would cost ~15 s a compile, and JAX's ``update_routing`` applies only
to that path, so the port's allgather and owner routings are both held to
the one JAX TP step), its category moments through the Pallas kernel in
interpret mode (``cal_use_pallas=True``; D = 128 and C = 16 meet its gate:
the port's moments are held to that kernel, not to the float32 XLA
fallback). The scenarios:

- the port's ``tp_layer_roles`` = JAX's over a grid of stacks and sizes;
- two TP steps at 2x2 and 1x4, both routings, the clip on (it binds), from
  one state (``convert.py``), injected negatives, no dropout, against JAX
  ``make_sharded_train_step(tensor_parallel=True)`` of the same mesh shape;
  the same at ``configs/in_batch_softmax.yaml``'s structure with the pod
  recipe's wire (``comm_dtype`` and ``features_dtype`` bfloat16) and
  ``embedding_exchange: alltoall``; and at ``model.precision: bfloat16``
  (2x2) against JAX's TP bf16 step, whose compiled HLO sums a column
  layer's float32 input gradient over ``model``, and every weight gradient
  over ``data``, before its bf16 rounding (the port rounds at the same
  points); and the bf16 mesh step without TP against JAX's non-TP step.
  Tolerances (``TOLERANCES``): losses rtol 1e-4, sparse moments
  atol 1e-6 (tests/test_parallel.py's); tables, dense parameters and dense
  moments atol 2e-5, the port-vs-JAX step tolerance of
  tests/torch_step_setup.py: an element whose first-step gradient is near
  Adam's eps moves by a visible part of lr when its sum runs in another
  order (one gate weight here: JAX's own TP and non-TP 2x2 steps differ
  there by 2.0e-5, the port's non-TP mesh step and JAX's TP step by 2.04e-5,
  the port's TP step and JAX's by 1.43e-5). Under the bf16 wire a lane's
  gradient summed in another order may round to the other bf16 neighbour,
  and the owner routing rounds each coalesced total once more: there at
  most ``FLIP_SHARE`` of a sparse moment's elements may exceed 1e-6, each
  within ``FLIP_BOUND`` ((1 - b1) times a few bf16 ulps of a lane's
  gradient; measured 6.1e-6 in at most 0.36% of a leaf). At bf16
  precision the step-1 gaps above move some bf16 operands of step 2 to
  the other neighbour; measured in the non-TP case: 5.02e-5 in 5 elements,
  all in one column of the item gate's fc1 weight (one unit's gradient
  moved as a whole, by 3-10% of its m, as when one sample's pre-activation
  of that unit sits on the other side of the ReLU kink), while JAX's own
  TP and non-TP steps are 7.5e-9 apart there. So at bf16 precision at
  most ``FLIP_SHARE`` of a table's or dense leaf's elements may exceed
  2e-5, each within ``RELU_FLIP_BOUND`` = 1e-4 (a tenth of lr). Each dense m
  leaf, whose elements the atol reads loosely (Adam's first steps move a
  weight by ~lr whatever its gradient's size), is also held to its norm:
  ``|m - m_jax| / |m_jax|`` within ``DENSE_M_REL`` (5e-5 in float32,
  measured at most 6.6e-6; 2e-3 with bf16 operands or wire, measured at
  most 6.8e-4 with TP and 5.0e-4 without), so a split leaf's gradient at a
  wrong scale fails;
- the first step's dense gradients (after the clip, before Adam), read
  from each dense leaf's first moment ``m_1 = (1 - b1) g``, where no eps
  has amplified a sum-order difference yet: each element within
  ``GRAD_RTOL`` of its leaf's largest (1e-4 in float32, measured at most
  2.2e-5; 2^-7, one bf16 ulp, with bf16 operands, measured 3.6e-4);
- dropout on (2x2 and 1x4), on two draws of batches: the TP step draws
  the non-TP mesh step's masks (the uniforms themselves compared, every
  draw whole-width), and the two steps agree at the tolerances above and
  in their first-step gradients; after the steps every
  replicated leaf and row-layer bias is bit-equal on every rank, and each
  split leaf on the data ranks of its model index;
- every collective of a TP step (``record_collectives``): each all-reduce over ``model``
  is batch-sized (rows of the data shard) or a vector of squared norms (the
  clip's), f's backward and g's forward among them; no collective carries a
  dense weight; the all-reduce of dense gradients over ``data`` carries
  ``1/s`` of each split leaf;
- checkpoints across layouts and packages: the ranks' TP sharded directory
  (JAX-oriented bounds, e.g. ``0:in;c0:c1`` for a column ``w``) read by JAX
  ``load_sharded_checkpoint`` and by one port process bit for bit, and back
  into a non-TP placement; JAX's TP directory read into a TP placement; a
  non-TP directory and a one-device one into TP placements; the flat file
  of a TP mesh (gathered) read by both packages;
- ``run_single_experiment`` with ``mesh.tensor_parallel: true`` at 2x2 on
  the ranks: losses, sharded checkpoints, reports, a serving bundle; the
  export from its TP shard directory equals the export from a flat
  checkpoint of the same state bit for bit.
"""

import copy
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from torch_ranks import launch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.models.encoders import tp_layer_roles
from ttamm_torch.parallel.sharding import tp_leaf_dims
from ttamm_torch.pipelines.export import export_bundle, prepare_data
from ttamm_torch.train import checkpoint as port_ckpt
from ttamm_torch.train import create_train_state
from ttamm_torch.train import sharded_checkpoint as port_sharded
from ttamm_tpu.models.encoders import tp_layer_roles as jax_tp_layer_roles
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops.sampling import sample_negative_items as jax_sample
from ttamm_tpu.parallel import MeshConfig, build_mesh, pad_batch_data, pad_state_rows, place_data
from ttamm_tpu.parallel import place_state as jax_place_state
from ttamm_tpu.parallel.step import make_sharded_train_step
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import sharded_checkpoint as jax_sharded
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD, WALL_SECONDS = 4, 240

NU, NI, FU, FI, D, H, B, NEG, M, C, STEPS = 120, 80, 12, 9, 128, 32, 8, 3, 6, 16, 2


def tower(dropout: float = 0.0) -> dict:
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [H], "output_dim": D, "dropout": dropout},
        "fusion": "gated",
    }


MODELS = {
    # configs/default.yaml's structure (dense mimic tables), its precision
    "bce": {"user_encoder": tower(), "item_encoder": tower(), "similarity": "cosine",
            "adaptive_mimic": {"enabled": True}},
    # configs/in_batch_softmax.yaml's (sparse mimic tables)
    "pod": {"user_encoder": tower(), "item_encoder": tower(), "similarity": "cosine",
            "adaptive_mimic": {"enabled": True, "sparse": True}},
}
MODELS["bf16"] = dict(MODELS["bce"], precision="bfloat16")
MODELS["dropout"] = dict(MODELS["bce"], user_encoder=tower(0.2), item_encoder=tower(0.2))
COMMON = dict(num_items=NI, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
              lambda_category_alignment=0.01, cal_max_categories=C, gradient_clip_norm=0.5)
TSCFG = {
    "bce": dict(COMMON, negatives_per_positive=NEG),
    "pod": dict(COMMON, loss_type="in_batch_softmax", mixed_negatives=M, comm_dtype="bfloat16",
                embedding_exchange="alltoall"),
}
TSCFG["bf16"] = TSCFG["dropout"] = TSCFG["bce"]
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01)
# (structure, mesh) held to a JAX TP step, each under both routings
CASES = {"bce_2x2": ("bce", [2, 2]), "bce_1x4": ("bce", [1, 4]), "pod_2x2": ("pod", [2, 2]),
         "pod_1x4": ("pod", [1, 4]), "bf16_2x2": ("bf16", [2, 2])}
# (structure, mesh) of the bf16 mesh step without TP, held to JAX's non-TP
# step: it rounds each weight gradient after the sum over data, as JAX does
PLAIN_CASES = {"bf16_2x2_plain": ("bf16", [2, 2])}
ROUTINGS = ("allgather", "owner")
FLIP_SHARE, FLIP_BOUND = 5e-3, 1e-5  # the bf16 wire's sparse moments (see above)
RELU_FLIP_BOUND = 1e-4  # bf16 precision's tables and dense leaves (see above)
TOLERANCES = dict(loss=1e-4, dense=2e-5, sparse_moments=1e-6)
# the first step's dense gradients (after the clip, before Adam), each
# element within this share of its leaf's largest |g|: float32 sums in
# another order (measured at most 2.2e-5, on the dense item mimic table at
# 1x4), and with bf16 operands a rounding flip of one bf16 ulp (2^-7 of the
# element at most; measured 3.6e-4)
GRAD_RTOL = {"bce": 1e-4, "dropout": 1e-4, "pod": 1e-4, "bf16": 2.0**-7}
# a dense m leaf's error relative to its norm, by structure: float32, and
# with bf16 operands or wire (a gradient element rounded to the other bf16
# neighbour); measured at most 6.6e-6 and 6.8e-4 (see above)
DENSE_M_REL = {"bce": 5e-5, "dropout": 5e-5, "pod": 2e-3, "bf16": 2e-3}
DROPOUT_MESHES = {"2x2": [2, 2], "1x4": [1, 4]}


# ---------------------------------------------------------------------------
# (i) roles
# ---------------------------------------------------------------------------

ROLE_STACKS = [
    [(105, 256), (256, 128)],  # configs/default.yaml's feature MLP
    [(256, 128), (128, 128)],  # its gate
    [(12, 32)],  # one layer: never column-parallel
    [(12, 30), (30, 16)],  # 30 divides 2, not 4
    [(12, 32), (32, 48), (48, 16)],
    [(12, 33), (33, 32), (32, 16)],  # a replicated layer restarts the alternation
    [(9, 64), (64, 64), (64, 64), (64, 7)],
]


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("stack", range(len(ROLE_STACKS)))
def test_tp_layer_roles_match_jax(stack, size):
    shapes = ROLE_STACKS[stack]
    assert tp_layer_roles(shapes, size) == jax_tp_layer_roles(shapes, size)


# ---------------------------------------------------------------------------
# The JAX references and the one launch of the ranks
# ---------------------------------------------------------------------------


def _data(rng):
    feats = (rng.normal(0, 1, (NU, FU)).astype(np.float32),
             rng.normal(0, 1, (NI, FI)).astype(np.float32))
    cats = np.minimum(rng.geometric(0.3, NI) - 1, 20).astype(np.int32)
    pos = np.full((NU, 4), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 4)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    counts = np.maximum(np.floor(rng.pareto(1.2, NI) * 3), 1.0)
    log_q = np.log(counts / counts.sum()).astype(np.float32)
    return {"user_features": feats[0], "item_features": feats[1], "positive_rows": pos,
            "category_ids": cats, "item_log_q": log_q}


def _batches(rng, data, structure):
    """STEPS batches ``(u, p, negatives the port injects, JAX key)``: the
    negatives (the in-batch loss: the pool) JAX draws from the key."""
    out = []
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.key(5), s)
        u = rng.integers(0, NU, B).astype(np.int32)
        p = data["positive_rows"][u, 0].copy()
        sub = jax.random.split(key)[0]
        if structure == "pod":
            neg = np.array(jax.random.randint(sub, (M,), 0, NI, dtype=jnp.int32))
        else:
            neg = np.array(jax_sample(sub, jnp.asarray(data["positive_rows"][u]), num_items=NI,
                                      num_negatives=NEG, num_rounds=8))
        out.append((u, p, neg, key))
    return out


def _jax_tp_steps(structure, mesh_shape, flat, data, batches, tensor_parallel=True):
    """JAX's TP steps (``tensor_parallel=False``: its steps without TP) on
    its virtual mesh: the final state (flat host arrays), the losses
    (sorted keys) of each step and the dense first moments after the first
    step (``step1/opt_dense/m/...``)."""
    jcfg = jax_parse(MODELS[structure], user_feature_dim=FU, item_feature_dim=FI)
    template = jax_state.create_train_state(jax.random.key(0), jcfg, num_users=NU, num_items=NI)
    state = _jax_restore(template, flat)
    feat = jnp.bfloat16 if structure == "pod" else jnp.float32
    jdata = jax_state.BatchData(
        np.asarray(jnp.asarray(data["user_features"], feat)),
        np.asarray(jnp.asarray(data["item_features"], feat)),
        data["positive_rows"], data["category_ids"],
        data["item_log_q"] if structure == "pod" else None,
    )
    tscfg = jax_step.TrainStepConfig(**TSCFG[structure], use_pallas=False, cal_use_pallas=True,
                                     opt=jax_optim.DenseOptConfig(**OPT))
    mesh = build_mesh(MeshConfig(*mesh_shape))
    mp = mesh_shape[1]
    state = jax_place_state(mesh, pad_state_rows(state, mp), tensor_parallel=tensor_parallel)
    pdata = place_data(mesh, pad_batch_data(jdata, mp))
    step = make_sharded_train_step(jcfg, tscfg, mesh, state, pdata,
                                   tensor_parallel=tensor_parallel)
    losses, first = [], {}
    for u, p, _, key in batches:
        state, metrics = step(state, pdata, jnp.asarray(u), jnp.asarray(p), key)
        losses.append([float(metrics[k]) for k in sorted(metrics)])
        if not first:
            first = {f"step1/{k}": np.asarray(v) for k, v in jax_ckpt.state_to_host(state).items()
                     if k.startswith("opt_dense/m/")}
    return jax_ckpt.state_to_host(state), np.asarray(losses), first


def _jax_restore(template, flat):
    """A host JAX state of ``template``'s structure holding ``flat``."""
    keys = list(jax_ckpt.state_to_host(template))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), [np.asarray(flat[k]) for k in keys])


def _initial_flat(structure):
    """One seeded JAX state of the structure as flat host arrays (the port
    reads it through ``convert.py``)."""
    jcfg = jax_parse(MODELS[structure], user_feature_dim=FU, item_feature_dim=FI)
    return {k: np.asarray(v) for k, v in jax_ckpt.state_to_host(
        jax_state.create_train_state(jax.random.key(1), jcfg, num_users=NU, num_items=NI)).items()}


def _trainer_config(root: Path) -> dict:
    """configs/default.yaml at test widths (16-wide towers, a 32-wide hidden
    layer) on the tiny corpus under
    ``root``, on a 2x2 mesh with ``tensor_parallel: true``, one epoch."""
    config = yaml.safe_load((REPO / "configs" / "default.yaml").read_text())
    config["data"].update(root=str(root / "data"), interactions_limit=None,
                          min_user_interactions=2, min_item_interactions=2)
    config["data"]["feature_params"].update(category_top_k=5, author_top_k=4)
    for side in ("user_encoder", "item_encoder"):
        tw = config["model"][side]
        tw["id_embedding"]["params"]["embedding_dim"] = 16
        tw["feature_encoder"].update(hidden_dims=[H], output_dim=16)
        tw["output_dim"] = 16
    out = root / "run"
    config["training"].update(batch_size=256, num_epochs=1, category_alignment_max_categories=16)
    config["training"]["checkpointing"]["dir"] = str(out / "ckpt")
    config["experiment"]["benchmark_report"] = str(out / "reports" / "benchmark_summary.md")
    config["evaluation"]["faiss"].update(index_path=str(out / "faiss" / "items.index"),
                                         embedding_path=str(out / "faiss" / "item_embeddings.npy"))
    config["diagnostics"].update(
        report_path=str(out / "reports" / "recommendation_report.md"),
        loss_plot_path=str(out / "reports" / "loss_curve.png"),
        embedding_summary_path=str(out / "reports" / "embedding_diagnostics.json"),
    )
    config["logging"] = {"level": "WARNING"}
    config["mesh"] = {"data_parallel": 2, "model_parallel": 2, "tensor_parallel": True}
    return config


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_tp")
    rng = np.random.default_rng(0)
    data = _data(rng)
    inputs = {f"data/{k}": a for k, a in data.items()}
    tasks, refs, flats = [], {}, {}
    for structure in MODELS:
        flats[structure] = _initial_flat(structure)
        inputs.update({f"{structure}/{k}": a for k, a in flats[structure].items()})

    def step_task(name, structure, mesh, tensor_parallel=True, **extra):
        return dict(kind="train_step", name=name, model=MODELS[structure],
                    feature_dims=[FU, FI], num_users=NU, num_items=NI, state=structure,
                    mesh=mesh, steps=STEPS, opt=OPT, log_q=structure == "pod",
                    features_dtype="bfloat16" if structure == "pod" else "float32",
                    tensor_parallel=tensor_parallel, **extra)

    for case, (structure, mesh) in CASES.items():
        batches = _batches(rng, data, structure)
        for s, (u, p, neg, _) in enumerate(batches):
            inputs.update({f"{case}/u{s}": u, f"{case}/p{s}": p, f"{case}/neg{s}": neg})
        refs[case] = _jax_tp_steps(structure, mesh, flats[structure], data, batches)
        for routing in ROUTINGS:
            tasks.append(step_task(
                f"{case}_{routing}", structure, mesh, inputs_prefix=case,
                tscfg=dict(TSCFG[structure], update_routing=routing), first_moments=True,
                collectives=case == "bce_2x2" and routing == "allgather"))

    def dropout_tasks(label, mesh):
        batches = _batches(rng, data, "dropout")
        for s, (u, p, neg, _) in enumerate(batches):
            inputs.update({f"dropout_{label}/u{s}": u, f"dropout_{label}/p{s}": p,
                           f"dropout_{label}/neg{s}": neg})
        for tp in (True, False):
            tasks.append(step_task(
                f"dropout_{label}_{'tp' if tp else 'plain'}", "dropout", mesh,
                inputs_prefix=f"dropout_{label}", tscfg=TSCFG["dropout"], dropout=True,
                tensor_parallel=tp, first_moments=True))

    for label, mesh in DROPOUT_MESHES.items():
        dropout_tasks(label, mesh)

    # the bf16 mesh step without TP (its batches drawn after the others')
    for case, (structure, mesh) in PLAIN_CASES.items():
        batches = _batches(rng, data, structure)
        for s, (u, p, neg, _) in enumerate(batches):
            inputs.update({f"{case}/u{s}": u, f"{case}/p{s}": p, f"{case}/neg{s}": neg})
        refs[case] = _jax_tp_steps(structure, mesh, flats[structure], data, batches,
                                   tensor_parallel=False)
        for routing in ROUTINGS:
            tasks.append(step_task(f"{case}_{routing}", structure, mesh, tensor_parallel=False,
                                   inputs_prefix=case,
                                   tscfg=dict(TSCFG[structure], update_routing=routing)))
    # the dropout case again on a second draw of batches (drawn last)
    for label, mesh in DROPOUT_MESHES.items():
        dropout_tasks(f"{label}_draw2", mesh)

    # checkpoints: the trained 2x2 state, JAX's TP directory of it, and a
    # one-device port directory of it
    trained = {k: np.asarray(v) for k, v in refs["bce_2x2"][0].items()}
    trained = {k: v[: np.shape(flats["bce"][k])[0]] if v.ndim else v for k, v in trained.items()}
    inputs.update({f"trained/{k}": a for k, a in trained.items()})
    jcfg = jax_parse(MODELS["bce"], user_feature_dim=FU, item_feature_dim=FI)
    template = jax_state.create_train_state(jax.random.key(9), jcfg, num_users=NU, num_items=NI)
    jmesh = build_mesh(MeshConfig(2, 2))
    names = dict(experiment_name="jax", epoch=3, metric_name=None, metric_value=None,
                 template="{experiment}_epoch{epoch}")
    jax_dir = jax_sharded.save_sharded_checkpoint(
        work / "jax_tp", jax_place_state(jmesh, pad_state_rows(_jax_restore(template, trained), 2),
                                         tensor_parallel=True), **names)
    pcfg = port_parse(MODELS["bce"], user_feature_dim=FU, item_feature_dim=FI)
    one = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    from ttamm_torch.models.convert import train_state_from_flat

    one_dir = port_sharded.save_sharded_checkpoint(
        work / "one_device", train_state_from_flat(one, trained), experiment_name="one",
        epoch=3, metric_name=None, metric_value=None, template="{experiment}_epoch{epoch}")
    ckpt = dict(kind="checkpoint", model=MODELS["bce"], feature_dims=[FU, FI], num_users=NU,
                num_items=NI, state="trained", mesh=[2, 2], reload=True)
    tasks.append(dict(ckpt, name="ckpt_tp", tensor_parallel=True, flat=True,
                      save_dir=str(work / "port_tp"), jax_dir=str(jax_dir)))
    tasks.append(dict(ckpt, name="ckpt_plain", tensor_parallel=False,
                      load_tensor_parallel=True, save_dir=str(work / "port_plain"),
                      jax_dir=str(one_dir)))

    write_synthetic_csvs(work / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=5)
    config = _trainer_config(work)
    tasks.append(dict(kind="train_run", name="train_run", config=config))

    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], WORLD, work, WALL_SECONDS)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    return dict(work=work, refs=refs, outs=outs, trained=trained, template=template,
                config=config)


def _assert_flips(err, atol, bound, label, key):
    """At most ``FLIP_SHARE`` of a leaf's elements past ``atol``, each
    within ``bound``."""
    assert err.max(initial=0.0) <= bound, (label, key, err.max())
    assert (err > atol).sum() <= FLIP_SHARE * err.size, (label, key, int((err > atol).sum()))


def _assert_state_close(got, want, label, structure, wire=False):
    """Every leaf of ``want`` in ``got`` within ``TOLERANCES``, and each
    dense m leaf within ``DENSE_M_REL[structure]`` of its norm; with
    ``wire`` (the bf16 gradient wire) a sparse moment's rounding flips
    within ``FLIP_SHARE`` and ``FLIP_BOUND``; at bf16 precision the other
    leaves' ReLU flips within ``FLIP_SHARE`` and ``RELU_FLIP_BOUND``."""
    for key, value in want.items():
        value = np.asarray(value)
        if value.ndim:
            value = value[: got[key].shape[0]]  # JAX pads tables to its own multiple
        err = np.abs(got[key].astype(np.float64) - value)
        sparse = key.startswith("opt_sparse")
        if wire and sparse:
            _assert_flips(err, TOLERANCES["sparse_moments"], FLIP_BOUND, label, key)
        elif MODELS[structure].get("precision") == "bfloat16" and not sparse:
            _assert_flips(err, TOLERANCES["dense"], RELU_FLIP_BOUND, label, key)
        else:
            atol = TOLERANCES["sparse_moments"] if sparse else TOLERANCES["dense"]
            np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=f"{label} {key}")
        if key.startswith("opt_dense/m/"):
            # relative to the leaf's norm: a split leaf's gradient at a wrong
            # scale fails here, however small its elements are against atol
            rel = np.linalg.norm(got[key].astype(np.float64) - value) / np.linalg.norm(value)
            assert rel <= DENSE_M_REL[structure], (label, key, rel)


# ---------------------------------------------------------------------------
# (ii), (iii) TP steps against JAX's TP steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_matches_jax_tp_step(tp_run, case, routing):
    want, want_losses, _ = tp_run["refs"][case]
    got = tp_run["outs"][f"{case}_{routing}"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOLERANCES["loss"], atol=1e-7)
    structure = CASES[case][0]
    _assert_state_close(got, want, f"{case} {routing}", structure, wire=structure == "pod")


def _assert_grads_close(got, want, label, structure):
    """The first step's dense gradients (after the clip, before Adam) of
    ``got`` within ``GRAD_RTOL[structure]`` of ``want``'s, relative to each
    leaf's largest: read from the first moments, ``m_1 = (1 - b1) g``, where
    no eps has amplified a sum-order difference yet."""
    keys = [k for k in want if k.startswith("step1/")]
    assert keys
    for key in keys:
        value = np.asarray(want[key], np.float64)
        if value.ndim:
            value = value[: got[key].shape[0]]  # JAX pads tables to its own multiple
        err = np.abs(got[key] - value).max(initial=0.0)
        scale = np.abs(value).max(initial=0.0)
        assert err <= GRAD_RTOL[structure] * scale, (label, key, err / scale)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_dense_gradients_before_adam_match_jax(tp_run, case, routing):
    _assert_grads_close(tp_run["outs"][f"{case}_{routing}"], tp_run["refs"][case][2],
                        f"{case} {routing}", CASES[case][0])


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_bf16_mesh_step_without_tp_matches_jax(tp_run, case, routing):
    """``model.precision: bfloat16`` on the mesh without TP: each weight
    gradient rounded to bf16 after its sum over data (where JAX's mesh step
    rounds it), held to JAX's non-TP step at the same tolerances."""
    want, want_losses, _ = tp_run["refs"][case]
    got = tp_run["outs"][f"{case}_{routing}"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOLERANCES["loss"], atol=1e-7)
    _assert_state_close(got, want, f"{case} {routing}", PLAIN_CASES[case][0])


def _leaf_segments(structure, size):
    """``[(key, local numel, split)]`` of the port's dense parameters in
    ``dense_parameters`` order at a model axis of ``size``."""
    cfg = port_parse(MODELS[structure], user_feature_dim=FU, item_feature_dim=FI)
    model = create_train_state(cfg, num_users=NU, num_items=NI, seed=0, device="cpu").model
    split = tp_leaf_dims(model, size)
    return [(k, p.numel() // (size if k in split else 1), k in split)
            for k, p in model.dense_parameters()]


def _assert_ranks_agree(rank_dense, structure, mesh):
    """Every replicated leaf (row-layer biases among them) bit-equal on all
    ranks; each split leaf on the data ranks of its model index."""
    dp, mp = mesh
    at = 0
    for key, n, split in _leaf_segments(structure, mp):
        seg = rank_dense[:, at : at + n]
        at += n
        for r in range(1, dp * mp):
            if not split:
                np.testing.assert_array_equal(seg[r], seg[0], err_msg=key)
            elif r >= mp:
                np.testing.assert_array_equal(seg[r], seg[r % mp], err_msg=key)
    assert at == rank_dense.shape[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_stay_equal_across_ranks(tp_run, case):
    for routing in ROUTINGS:
        _assert_ranks_agree(tp_run["outs"][f"{case}_{routing}"]["rank_dense"], *CASES[case])


# ---------------------------------------------------------------------------
# (iv) dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(DROPOUT_MESHES))
def test_tp_dropout_draws_the_non_tp_masks(tp_run, mesh):
    _check_dropout(tp_run, mesh, mesh)


@pytest.mark.parametrize("mesh", sorted(DROPOUT_MESHES))
def test_tp_dropout_on_a_second_draw(tp_run, mesh):
    _check_dropout(tp_run, f"{mesh}_draw2", mesh)


def _check_dropout(tp_run, label, mesh):
    """The TP and non-TP steps of ``label``'s batches on ``mesh`` with
    dropout: the same masks, losses, first-step dense gradients and state."""
    tp, plain = (tp_run["outs"][f"dropout_{label}_{kind}"] for kind in ("tp", "plain"))
    # every draw whole-width ([rows of the data shard, H]) on every rank,
    # and the masks (uniform < 1 - rate) those of the non-TP step
    dp = DROPOUT_MESHES[mesh][0]
    assert {tuple(s) for s in tp["draw_shapes"]} <= {(B // dp, H), (B // dp * (1 + NEG), H)}
    np.testing.assert_array_equal(tp["draw_shapes"], plain["draw_shapes"])
    np.testing.assert_array_equal(tp["draws"] < 0.8, plain["draws"] < 0.8)
    np.testing.assert_array_equal(tp["draws"], plain["draws"])
    assert (tp["draws"] >= 0.8).any()  # some units dropped
    np.testing.assert_allclose(tp["losses"], plain["losses"], rtol=TOLERANCES["loss"], atol=1e-7)
    _assert_grads_close(tp, plain, label, "dropout")
    _assert_state_close(tp, {k: v for k, v in plain.items() if "/" in k and not k.startswith("step1/")},
                        label, "dropout")
    _assert_ranks_agree(tp["rank_dense"], "dropout", DROPOUT_MESHES[mesh])


# ---------------------------------------------------------------------------
# (v) the collectives of a TP step
# ---------------------------------------------------------------------------


def test_tp_step_collectives_are_batch_sized(tp_run):
    out = tp_run["outs"]["bce_2x2_allgather"]
    records = out["collectives"]
    # the record lists every torch.distributed collective the step called
    assert len(records) == int(out["dist_calls"])
    segments = _leaf_segments("bce", 2)
    dp = 2
    users, items = B // dp, B // dp * (1 + NEG)
    model_reduces = [tuple(int(x) for x in shape.split("x")) for op, axis, shape, _ in records
                     if op == "all-reduce" and axis == "model"]
    assert model_reduces
    for shape in model_reduces:
        batch_sized = shape[0] in (users, items)
        norms = len(shape) == 1 and shape[0] <= len(segments)
        assert batch_sized or norms, shape
    # f's backward (the gate's [id; feat] input, 2D wide) and g's forward
    # (the row layers' [n, D] outputs) on both towers
    for n in (users, items):
        assert (n, 2 * D) in model_reduces and (n, D) in model_reduces
    # no collective carries a dense weight, whole or sliced
    cfg = port_parse(MODELS["bce"], user_feature_dim=FU, item_feature_dim=FI)
    model = create_train_state(cfg, num_users=NU, num_items=NI, seed=0, device="cpu").model
    weights = set()
    for _, p in model.dense_parameters():
        if p.ndim == 2:
            o, i = p.shape
            weights |= {(o, i), (i, o), (o // 2, i), (o, i // 2), (i // 2, o), (i, o // 2)}
    for op, axis, shape, _ in records:
        dims = tuple(int(x) for x in shape.split("x"))
        assert dims not in weights or dims[0] in (users, items), (op, axis, shape)
    # the dense gradients' sum over data: 1/s of each split leaf
    local = sum(n for _, n, _ in segments)
    whole = sum(n * (2 if split else 1) for _, n, split in segments)
    data_reduces = [int(shape) for op, axis, shape, _ in records
                    if op == "all-reduce" and axis == "data" and "x" not in shape]
    assert local in data_reduces and whole not in data_reduces and local < whole


# ---------------------------------------------------------------------------
# (vi) checkpoints across layouts and packages
# ---------------------------------------------------------------------------


def _assert_same(got, want, label=""):
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=f"{label}{key}")


def test_tp_sharded_directory_read_by_jax_and_one_device(tp_run):
    trained = tp_run["trained"]
    ckpt = tp_run["work"] / "port_tp" / "port_epoch3"
    # rank 1 (data 0, model 1) writes its column and row slices in JAX's
    # [in, out] orientation; the row layer's bias is rank 0's
    with np.load(ckpt / "shards_p00001.npz") as blob:
        keys = set(blob.files)
    prefix = "dense/user_tower/feature_encoder/layers"
    assert {f"{prefix}/0/w::0:{FU};{H // 2}:{H}", f"{prefix}/0/b::{H // 2}:{H}",
            f"{prefix}/1/w::{H // 2}:{H};0:{D}", f"opt_dense/m/{prefix}/0/w::0:{FU};{H // 2}:{H}",
            f"dense/user_tower/gate/fc1/w::0:{2 * D};{D // 2}:{D}"} <= keys
    assert not any(k.startswith(f"{prefix}/1/b::") for k in keys)
    with np.load(ckpt / "shards_p00002.npz") as blob:  # data shard 1 writes none of them
        assert not any(k.startswith("dense/") for k in blob.files)
    restored, meta = jax_sharded.load_sharded_checkpoint(ckpt, tp_run["template"])
    assert meta["num_processes"] == WORLD
    _assert_same(jax_ckpt.state_to_host(restored), trained, "jax ")
    cfg = port_parse(MODELS["bce"], user_feature_dim=FU, item_feature_dim=FI)
    fresh = create_train_state(cfg, num_users=NU, num_items=NI, seed=3, device="cpu")
    fresh, _ = port_sharded.load_sharded_checkpoint(ckpt, fresh)
    _assert_same(train_state_to_flat(fresh), trained, "one device ")


@pytest.mark.parametrize("saved", ["tp", "plain"])
def test_sharded_checkpoints_cross_tp_and_non_tp_on_the_mesh(tp_run, saved):
    """``tp``: JAX's TP directory read into a TP placement, the ranks' TP
    directory into a non-TP one; ``plain``: a one-device directory into a
    TP placement, the ranks' non-TP directory into a TP one. Bit for bit."""
    got = tp_run["outs"][f"ckpt_{saved}"]
    assert int(got["epoch"]) == 3
    _assert_same(got, tp_run["trained"], "loaded ")
    _assert_same({k[len("reloaded/"):]: v for k, v in got.items() if k.startswith("reloaded/")},
                 tp_run["trained"], "reloaded ")


def test_flat_checkpoint_of_a_tp_mesh(tp_run):
    """Gathered on the TP mesh and written by rank 0: both packages read it."""
    path = tp_run["work"] / "port_tp" / "flat" / "port_epoch3"
    trained = tp_run["trained"]
    cfg = port_parse(MODELS["bce"], user_feature_dim=FU, item_feature_dim=FI)
    fresh = create_train_state(cfg, num_users=NU, num_items=NI, seed=3, device="cpu")
    fresh, _ = port_ckpt.load_checkpoint(path, fresh)
    _assert_same(train_state_to_flat(fresh), trained, "port ")
    restored, _ = jax_ckpt.load_checkpoint(path, tp_run["template"])
    _assert_same(jax_ckpt.state_to_host(restored), trained, "jax ")


# ---------------------------------------------------------------------------
# (vii) the trainer
# ---------------------------------------------------------------------------


def test_trainer_runs_tensor_parallel_on_the_mesh(tp_run, tmp_path):
    got, config = tp_run["outs"]["train_run"], tp_run["config"]
    assert bool(got["tensor_parallel"])
    assert np.isfinite(got["train_loss"]).all() and np.isfinite(got["val_loss"]).all()
    best = Path(str(got["best_checkpoint"]))
    assert sorted(p.name for p in best.glob("shards_p*.npz")) == [
        f"shards_p{r:05d}.npz" for r in range(WORLD)]
    assert Path(str(got["last_checkpoint"])).is_dir()
    for key in ("report_path", "embedding_summary_path"):
        assert Path(config["diagnostics"][key]).is_file()
    faiss = Path(config["evaluation"]["faiss"]["index_path"]).parent
    assert all((faiss / name).is_file() for name in ("items.index", "vocab.json"))
    # the export from the TP shard directory = the export of a flat
    # checkpoint of the same state, bit for bit
    dataset = prepare_data(config)
    export_bundle(copy.deepcopy(config), tmp_path / "dir", device="cpu", checkpoint=best,
                  dataset=dataset)
    cfg = port_parse(config["model"], user_feature_dim=dataset.user_feature_matrix.shape[1],
                     item_feature_dim=dataset.item_feature_matrix.shape[1])
    state = create_train_state(cfg, num_users=len(dataset.user_mapping),
                               num_items=len(dataset.item_mapping), seed=0, device="cpu")
    state, _ = port_sharded.load_sharded_checkpoint(best, state)
    flat = port_ckpt.save_checkpoint(tmp_path / "flat_ckpt", train_state_to_flat(state),
                                     experiment_name="tp", epoch=1, metric_name=None,
                                     metric_value=None)
    export_bundle(copy.deepcopy(config), tmp_path / "flat", device="cpu", checkpoint=flat,
                  dataset=dataset)
    for name in ("items.index", "vocab.json"):
        assert (tmp_path / "dir" / name).read_bytes() == (tmp_path / "flat" / name).read_bytes()
    for name in ("item_embeddings.npy", "user_embeddings.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "dir" / name),
                                      np.load(tmp_path / "flat" / name), err_msg=name)
