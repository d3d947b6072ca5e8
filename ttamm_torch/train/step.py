"""The training step, the eval-loss step and corpus encoding (port of
``ttamm_tpu/train/step.py``).

One training step, in the JAX step's order:

1. draw the extra item lanes on the device: under ``loss_type="bce"`` the
   sampled negatives (5 per positive by default), under
   ``"in_batch_softmax"`` a pool of ``mixed_negatives`` uniform ids shared
   by the whole batch (possibly empty);
2. gather every table's rows as fresh leaf tensors (outside the
   differentiated function, so table gradients arrive batch-row shaped;
   the sparse tables, ID and, under ``adaptive_mimic.sparse``, mimic,
   through the ``gather_rows`` kernel); feature rows stored in bfloat16
   (``data.features_dtype``) are widened in the towers;
3. run the towers (dropout from the caller's generator) and the mimic;
4. the retrieval loss (BCE over [positives; negatives], or the in-batch
   softmax of :func:`in_batch_softmax_loss` over [every positive; the
   pool]) + the mimic losses + category alignment;
5. backward;
6. rebuild each dense table's gradient by a fixed-order row sum (each row
   gradient rounded to ``comm_dtype`` first);
7. the optional global-norm clip (sparse row gradients coalesced first,
   from their unrounded float32 lanes);
8. the dense optimizer over the dense parameters and dense tables;
9. sparse-row Adam on the sparse tables (their lanes rounded to
   ``comm_dtype`` after the clip's scale, widened again before the
   coalesce; one ``sparse_adam_rows`` kernel a table).

``comm_dtype="bfloat16"`` (the JAX ``comm_cast``) rounds every table-row
gradient once where it would cross the mesh, and on one device too, so its
effect on quality shows on one card; all optimizer math stays float32 after
the widen. The rounding point differs by table kind, as in the JAX step: a
dense table's lanes before the clip's norm, a sparse table's after the
clip's scale (and under the owner routing each coalesced total once more,
``parallel/sparse_update.py``).

With ``mesh`` (a ``DeviceMesh`` with dims ``("data", "model")``, one process
per device) the step runs on this rank's parts of a state and data placed by
``ttamm_torch.parallel.sharding``: the same body reads, reduces and
updates through :class:`_Mesh` instead of :class:`_OneDevice`. On a
state placed with ``place_state(tensor_parallel=True)``
(``mesh.tensor_parallel``, which the state records) the towers run their
split layers through the mesh's tensor-parallel contexts
(``models/encoders.py``); on one device there is no such placement, as in
the JAX package, which builds no mesh there.

The state is updated in place. Parity notes (as in the JAX package):
training logits are dot products whatever ``model.similarity`` says; mimic
targets are the base (pre-augmentation) opposite-tower embeddings;
negatives (and the pool) get mimic augmentation but no mimic loss;
category alignment sees the augmented positive and negative (or pool) item
embeddings; the eval loss is the same retrieval loss without dropout and
without the auxiliary terms.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..device import host_to_device
from ..models.adaptive_mimic import mimic_forward
from ..models.encoders import TPContext
from ..models.two_tower import ModelConfig, TwoTower
from ..ops import device_cond, kernels
from ..ops.losses import bce_with_logits, category_alignment_loss
from ..ops.sampling import sample_negative_items
from ..ops.sparse_adam import coalesce_row_grads, sparse_adam_apply, sum_rows
from .optim import DENSE_SCALARS, DenseOptConfig, dense_opt_apply, dense_scalars, lr_scale
from .state import BatchData, TrainState, dense_table_names, sparse_table_names

LOSSES = ("bce", "in_batch_softmax")
COMM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EXCHANGES = ("gspmd", "alltoall")


class TrainStepConfig(NamedTuple):
    num_items: int
    negatives_per_positive: int = 5  # bce only
    loss_type: str = "bce"  # one of LOSSES
    lambda_mimic_user: float = 0.0
    lambda_mimic_item: float = 0.0
    lambda_category_alignment: float = 0.0
    gradient_clip_norm: float | None = None
    cal_max_categories: int = 64
    sampling_rounds: int = 8
    # In-batch softmax only: the logits' temperature, the logQ correction
    # over ``BatchData.item_log_q`` (uncorrected where that is None), and
    # the number of uniform draws shared by the batch as extra candidates
    # (the mixed negatives; 0 = in-batch negatives alone).
    softmax_temperature: float = 1.0
    logq_correction: bool = True
    mixed_negatives: int = 0
    # Decoupled weight decay on the sparse tables' touched rows (0 = SparseAdam).
    sparse_weight_decay: float = 0.0
    # Under a mesh: the row-gradient exchange of the sparse tables
    # ('allgather' | 'owner' | 'owner_unchecked', parallel/sparse_update.py)
    # and the owner routing's buffer size relative to a balanced share.
    update_routing: str = "allgather"
    update_capacity_factor: float = 2.0
    # The wire dtype of the table-row gradients (one of COMM_DTYPES):
    # 'bfloat16' rounds each one once, on one device as on a mesh.
    comm_dtype: str = "float32"
    # Under a mesh: how the tables' rows are read (one of EXCHANGES):
    # 'gspmd', one masked gather_rows a table summed over model; 'alltoall',
    # the bucketed exchange of parallel/exchange.py. Unread on one device.
    embedding_exchange: str = "gspmd"
    opt: DenseOptConfig = DenseOptConfig()


def _gather_opt(features: torch.Tensor | None, idx: torch.Tensor) -> torch.Tensor | None:
    if features is None or features.numel() == 0:
        return None
    return torch.index_select(features, 0, idx)


def _negatives(
    tscfg: TrainStepConfig,
    data: BatchData,
    u_idx: torch.Tensor,
    generator: torch.Generator | None,
    negatives: torch.Tensor | None,
    lookup=_gather_opt,
) -> torch.Tensor:
    """Flat int32 ``[B * NEG]`` negatives: the injected ones, else drawn
    (``lookup(positive_rows, u_idx)`` reads the users' positives)."""
    if negatives is not None:
        return negatives.reshape(-1).to(torch.int32)
    if generator is None:
        raise ValueError("a generator is needed to draw the negatives")
    return sample_negative_items(
        lookup(data.positive_rows, u_idx),
        num_items=tscfg.num_items,
        num_negatives=tscfg.negatives_per_positive,
        generator=generator,
        num_rounds=tscfg.sampling_rounds,
    ).reshape(-1)


def _pool(
    tscfg: TrainStepConfig,
    device: torch.device,
    generator: torch.Generator | None,
    negatives: torch.Tensor | None,
) -> torch.Tensor:
    """Int32 ``[M]`` ids of the in-batch loss's shared pool: the injected
    ones, else ``mixed_negatives`` uniform draws (none at M = 0)."""
    if negatives is not None:
        return negatives.reshape(-1).to(torch.int32)
    if tscfg.mixed_negatives == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    if generator is None:
        raise ValueError("a generator is needed to draw the mixed negatives")
    return torch.randint(
        0, tscfg.num_items, (tscfg.mixed_negatives,), generator=generator, device=device,
        dtype=torch.int32,
    )


class _Batch(NamedTuple):
    """One step's lanes on this rank: ``size`` the whole batch, this rank's
    users ``[lo, hi)`` of it (``users``), its item lanes (``items``: [its
    positives; their negatives], or under the in-batch loss [its positives;
    its part of the pool]) and, under the in-batch loss only, the
    candidates' ids (``candidates``: every positive of the batch, then the
    pool)."""

    size: int
    lo: int
    hi: int
    users: torch.Tensor
    items: torch.Tensor
    candidates: torch.Tensor | None = None


def _row_indices(bt: _Batch) -> dict[str, torch.Tensor]:
    """Which rows of each table a step reads: users for the user tables,
    the item lanes for the item tables."""
    return {"user_id": bt.users, "user_aug": bt.users, "item_id": bt.items, "item_aug": bt.items}


def _forward_embeddings(
    model: TwoTower,
    tscfg: TrainStepConfig,
    data: BatchData,
    u_idx: torch.Tensor,
    item_idx_all: torch.Tensor,
    rows: dict[str, torch.Tensor],
    generator: torch.Generator | None,
    lookup=_gather_opt,
    tp: dict[str, TPContext] | None = None,
):
    """``(user_emb, pos_emb, neg_emb, mimic_user_loss, mimic_item_loss)``
    from pre-gathered table rows (items ordered [positives; the rest]);
    ``neg_emb`` is ``[B, NEG, D]`` under the BCE loss and the flat pool
    ``[M, D]`` under the in-batch loss. Dropout only with a ``generator``.
    ``lookup(features, idx)`` reads feature rows; ``tp``: each tower's
    tensor-parallel context, by side."""
    batch = u_idx.shape[0]
    tp = tp or {}
    user_base = model.user_tower.forward_rows(
        rows["user_id"], lookup(data.user_features, u_idx), generator=generator,
        tp=tp.get("user"),
    )
    item_base_all = model.item_tower.forward_rows(
        rows["item_id"], lookup(data.item_features, item_idx_all), generator=generator,
        tp=tp.get("item"),
    )
    pos_base, neg_base = item_base_all[:batch], item_base_all[batch:]
    zero = user_base.new_zeros(())
    if model.cfg.mimic_enabled:
        item_aug = rows["item_aug"]
        user_emb, pos_emb, mu_loss, mi_loss = mimic_forward(
            rows["user_aug"], item_aug[:batch], user_base, pos_base
        )
        neg_emb = neg_base + item_aug[batch:]
    else:
        user_emb, pos_emb, neg_emb = user_base, pos_base, neg_base
        mu_loss = mi_loss = zero
    if tscfg.loss_type == "bce":
        neg_emb = neg_emb.reshape(batch, tscfg.negatives_per_positive, -1)
    return user_emb, pos_emb, neg_emb, mu_loss, mi_loss


def _bce_stack(user_emb, pos_emb, neg_emb) -> torch.Tensor:
    pos_logits = torch.sum(user_emb * pos_emb, dim=-1)
    neg_logits = torch.einsum("bd,bnd->bn", user_emb, neg_emb).reshape(-1)
    logits = torch.cat([pos_logits, neg_logits])
    labels = torch.cat([torch.ones_like(pos_logits), torch.zeros_like(neg_logits)])
    return bce_with_logits(logits, labels)


def in_batch_softmax_loss(
    user_emb: torch.Tensor,
    pos_emb: torch.Tensor,
    pos_idx: torch.Tensor,
    *,
    neg_emb: torch.Tensor | None = None,
    neg_idx: torch.Tensor | None = None,
    num_items: int = 0,
    cand_log_q: torch.Tensor | None = None,
    temperature: float = 1.0,
    row_offset: int = 0,
) -> torch.Tensor:
    """Sampled softmax with in-batch negatives (the JAX
    ``_in_batch_softmax_loss``).

    Row ``i``'s candidates are every positive of the batch (``pos_emb``
    ``[B, D]`` at ids ``pos_idx``), then the shared pool of mixed negatives
    (``neg_emb`` ``[M, D]`` at ``neg_idx``; none at M = 0): logits
    ``[n, B + M]``, plain dot products (two matmuls, as the JAX step). Its
    label is its own positive; a candidate with row ``i``'s item anywhere
    else (an accidental hit: a duplicate positive, a pool draw) is masked
    with the float32 minimum. Returns minus the mean log-probability of
    the labels.

    ``user_emb`` ``[n, D]`` are rows ``[row_offset, row_offset + n)`` of
    the batch: all of it on one device, a data shard's rows on a mesh
    (whose caller weighs the mean by n / B). ``temperature`` divides the
    logits. ``cand_log_q`` ``[B + M]``: each candidate's log sampling
    probability (``BatchData.item_log_q`` at ``[pos_idx; neg_idx]``),
    subtracted from its logit (the logQ correction); with a pool, the
    mixture ``log((B q + M / num_items) / (B + M))`` instead.
    """
    batch, n = pos_idx.shape[0], user_emb.shape[0]
    logits = torch.matmul(user_emb, pos_emb.T)
    cand_idx = pos_idx
    mixed = neg_emb is not None and neg_emb.shape[0] > 0
    if mixed:
        logits = torch.cat([logits, torch.matmul(user_emb, neg_emb.T)], dim=1)
        cand_idx = torch.cat([pos_idx, neg_idx])
    if temperature != 1.0:
        logits = logits / temperature
    if cand_log_q is not None:
        if mixed:
            m = neg_emb.shape[0]
            cand_log_q = torch.log((batch * torch.exp(cand_log_q) + m / num_items) / (batch + m))
        logits = logits - cand_log_q[None, :]
    rows = torch.arange(n, device=logits.device) + row_offset
    diag = torch.arange(logits.shape[1], device=logits.device)[None, :] == rows[:, None]
    hit = cand_idx[None, :] == pos_idx[row_offset : row_offset + n, None]
    logits = logits.masked_fill(hit & ~diag, torch.finfo(logits.dtype).min)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(log_probs, offset=row_offset))


def _retrieval_loss(layout, tscfg: TrainStepConfig, data: BatchData, bt: _Batch,
                    user_emb, pos_emb, neg_emb) -> torch.Tensor:
    """This rank's mean retrieval loss: the BCE stack, or the in-batch
    softmax over the candidates the layout assembles."""
    if bt.candidates is None:
        return _bce_stack(user_emb, pos_emb, neg_emb)
    pos_all, pool_all = layout.candidates(pos_emb, neg_emb, bt)
    log_q = None
    if tscfg.logq_correction and data.item_log_q is not None:
        log_q = layout.lookup(data.item_log_q, bt.candidates)
    return in_batch_softmax_loss(
        user_emb, pos_all, bt.candidates[: bt.size], neg_emb=pool_all,
        neg_idx=bt.candidates[bt.size :], num_items=tscfg.num_items, cand_log_q=log_q,
        temperature=tscfg.softmax_temperature, row_offset=bt.lo,
    )


def _check_config(tscfg: TrainStepConfig) -> None:
    if tscfg.loss_type not in LOSSES:
        raise ValueError(f"Unsupported training.loss: {tscfg.loss_type} (one of {LOSSES})")
    if tscfg.softmax_temperature <= 0.0:
        raise ValueError("training.softmax_temperature must be > 0")
    if tscfg.mixed_negatives < 0:
        raise ValueError("training.mixed_negatives must be >= 0")
    if tscfg.comm_dtype not in COMM_DTYPES:
        raise ValueError(f"Unknown comm_dtype: {tscfg.comm_dtype}")
    if tscfg.embedding_exchange not in EXCHANGES:
        raise ValueError(f"Unknown embedding_exchange: {tscfg.embedding_exchange}")


TrainStep = Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]


class _Lanes(NamedTuple):
    """One sparse table's update lanes: global row ids, their gradients and,
    under a mesh, the permutation of the lanes gathered over ``data`` into
    the one-device lane order (None where it is the identity) and, once the
    clip has gathered and sorted them, those lanes of every data shard
    (``parallel.sparse_update.SortedLanes``, which the update reuses)."""

    idx: torch.Tensor
    grad: torch.Tensor
    order: torch.Tensor | None = None
    gathered: Any = None

    def scaled(self, scale: torch.Tensor) -> "_Lanes":
        """Every gradient times ``scale`` (the clip)."""
        gathered = None if self.gathered is None else self.gathered.scaled(scale)
        return self._replace(grad=self.grad * scale, gathered=gathered)

    def on_wire(self, dtype: torch.dtype) -> "_Lanes":
        """The gradients rounded to the wire dtype. The clip's lanes,
        gathered in float32 for its norm, are dropped then: the update
        gathers the rounded ones."""
        if dtype == self.grad.dtype:
            return self
        return self._replace(grad=self.grad.to(dtype), gathered=None)


class _OneDevice:
    """Where the step reads rows, reduces and updates the sparse tables on
    one device: plain row reads, no collectives. :class:`_Mesh` swaps in the
    sharded reads and adds the collectives; the step body is shared."""

    mesh = None

    def __init__(self, tscfg: TrainStepConfig):
        self.wire = COMM_DTYPES[tscfg.comm_dtype]

    def shard(self, batch: int) -> tuple[int, int]:
        """Lanes ``[lo, hi)`` of the batch that this rank trains on."""
        return 0, batch

    def dropout(self, generator, dropout_generator):
        return generator if dropout_generator is None else dropout_generator

    def lookup(self, features: torch.Tensor | None, idx: torch.Tensor) -> torch.Tensor | None:
        """Rows of a table, feature matrix or dataset array, outside autograd."""
        return _gather_opt(features, idx)

    def table_rows(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows of a sparse table (ID, or mimic under
        ``adaptive_mimic.sparse``) at int32 ids, outside autograd: the
        ``gather_rows`` kernel (the same copy as ``index_select``)."""
        return kernels.gather_rows(table, idx)

    def dense_table_rows(self, table: torch.Tensor, idx: torch.Tensor, side: str, bt: _Batch):
        """``(grad_input, rows)``: the tensor whose gradient the step takes
        and the differentiable rows of a dense (optimizer-updated) table, at
        the ``side`` lanes of ``bt``."""
        rows = torch.index_select(table, 0, idx).requires_grad_()
        return rows, rows

    def table_grad(self, grad: torch.Tensor, idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The table-shaped gradient from ``grad_input``'s, each row
        gradient rounded to the wire dtype (duplicates summed after)."""
        return sum_rows(idx, grad.to(self.wire).to(grad.dtype), table.shape[0])

    def weigh(self, batch: int, n_local: int, terms: list[torch.Tensor]) -> list[torch.Tensor]:
        return terms

    def reduce_losses(self, terms: list[torch.Tensor]) -> list[torch.Tensor]:
        return [t.detach() for t in terms]

    def reduce_dense(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        return grads

    def reduce_table_sq(self, sq: torch.Tensor) -> torch.Tensor:
        return sq

    def tp(self, state: TrainState) -> dict[str, TPContext] | None:
        """The towers' tensor-parallel contexts for ``state``, by side; None
        without tensor parallelism (always so on one device)."""
        return None

    def dense_sq(self, grads: list[torch.Tensor], tp) -> list[torch.Tensor]:
        """Each dense gradient's squared norm (the clip's), in
        ``dense_parameters`` order; ``tp`` as :meth:`tp` gave it."""
        return [torch.sum(torch.square(g)) for g in grads]

    def candidates(self, pos_emb: torch.Tensor, pool_emb: torch.Tensor, bt: _Batch):
        """``(every positive's embedding [B, D], the pool's [M, D])``: the
        in-batch loss's candidates."""
        return pos_emb, pool_emb

    def lanes(self, side: str, idx: torch.Tensor, grad: torch.Tensor, bt: _Batch) -> _Lanes:
        return _Lanes(idx, grad)

    def sparse_sq(self, table: torch.Tensor, lanes: _Lanes) -> tuple[_Lanes, torch.Tensor]:
        """``(lanes, squared norm of a sparse table's gradient)``, duplicate
        rows summed."""
        _, summed = coalesce_row_grads(lanes.idx, lanes.grad, scratch_row=table.shape[0] - 1)
        return lanes, torch.sum(torch.square(summed))

    def sparse_update(self, table, opt_state, lanes: _Lanes, tscfg: TrainStepConfig,
                      scalars: torch.Tensor) -> None:
        """Sparse-row Adam on one table at the step's f32 scalars
        (``kernels.adam_scalars``' row on the device)."""
        sparse_adam_apply(
            table, opt_state, lanes.idx, lanes.grad, scalars=scalars,
            decay=bool(tscfg.sparse_weight_decay),
        )


class _Mesh(_OneDevice):
    """The step on one rank of a ``(data, model)`` mesh.

    ``state`` and ``data`` are this rank's parts (``parallel.sharding``: row
    slices of every table, moment and dataset array, a whole copy of the
    dense parameters); ``u_idx`` / ``pos_idx`` are the whole batch, the same
    on every rank. Against the one-device step:

    1. the negatives of the whole batch (or the in-batch loss's pool) come
       from ``generator``, which every rank seeds alike (or ``negatives``);
       this rank then trains on its data shard of the batch and, under the
       in-batch loss, encodes its data shard of the pool
       (:func:`_data_shard`). A mesh run and a one-device run of one seed
       draw the same negatives only with dropout off, or with the
       one-device step's masks from a ``dropout_generator`` of its own
       (else they come from ``generator`` and shift its stream);
    2. rows come through the sharded lookups, one masked ``gather_rows`` a
       table at any number of model shards: the sparse tables' (ID, and
       mimic under ``adaptive_mimic.sparse``) as fresh leaves
       (``sharded_table_rows``), the dense tables' (the mimic tables by
       default) through ``sharded_lookup``, whose backward gives this
       shard's table gradient summed over data; under
       ``embedding_exchange="alltoall"`` every table's rows come through the
       all-to-all exchange instead (``parallel/exchange.py``: the same rows
       and, for the dense tables, the same gradient bits);
    3. dropout comes from ``dropout_generator`` (this rank's own; none
       without it); each loss term is weighted by the shard's share of the
       batch, so the sums over data are the global means; the
       category-alignment statistics are summed over data (each pool row
       counted once, on the rank that encodes it); the in-batch loss reads
       every positive's and pool row's embedding through an all-gather over
       data whose backward sums the gradient over data
       (``all_gather_rows_grad``), so each row keeps one dropout mask;
    4. dense gradients are summed over data (model ranks hold the same batch
       rows, so never over model); on a tensor-parallel state a split
       layer's gradient is this rank's slice, so the sum over data carries
       ``1/s`` of it, and the towers' own collectives are the batch-sized
       sums over model of ``models/encoders.py`` (f and g);
    5. the clip norm is global: the dense tables' shards summed over model,
       each split dense parameter's slices summed over model (each whole
       one counted once),
       each sparse table's duplicate rows summed over the whole batch, its
       lanes gathered over data and sorted once (``gather_lanes``);
    6. ``sharded_sparse_adam_update`` (``update_routing``) updates the sparse
       tables, with the lanes in the one-device order (the clip's gathered
       lanes, scaled, where it ran and ``comm_dtype`` is float32; else the
       rounded lanes, gathered again in the wire dtype): one
       ``sparse_adam_rows`` a table.
    """

    def __init__(self, mesh, tscfg: TrainStepConfig):
        from ..parallel import embedding_lookup, exchange, sharding, sparse_update
        from ..parallel import mesh as pmesh

        super().__init__(tscfg)
        self.mesh, self._lookup, self._update, self._pm = mesh, embedding_lookup, sparse_update, pmesh
        self._sharding = sharding
        self._tp = self._split_at = None  # built on the first tensor-parallel state
        self._exchange = exchange if tscfg.embedding_exchange == "alltoall" else None
        self.dp = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
        self.d = pmesh.axis_index(mesh, pmesh.DATA_AXIS)
        self.num_neg = tscfg.negatives_per_positive
        self._indices: dict[tuple, torch.Tensor] = {}  # the lane orders, on the device

    def _on_device(self, key: tuple, index: np.ndarray, device: torch.device) -> torch.Tensor:
        """The host array ``index`` (named by ``key``) on ``device``,
        uploaded once, by the first (eager) step that needs it, so that a
        captured step reads it from the card."""
        key = (*key, device)
        if key not in self._indices:
            self._indices[key] = torch.from_numpy(index).to(device)
        return self._indices[key]

    def shard(self, batch):
        return _data_shard(batch, self.dp, self.d)

    def dropout(self, generator, dropout_generator):
        return dropout_generator

    def lookup(self, features, idx):
        return self._lookup.sharded_rows(features, idx, self.mesh)

    def table_rows(self, table, idx):
        if self._exchange is not None:
            return self._exchange.exchange_rows(table, idx, self.mesh)
        return self._lookup.sharded_table_rows(table, idx, self.mesh)

    def dense_table_rows(self, table, idx, side, bt):
        leaf = table.detach().requires_grad_()
        # the backward gathers the lanes over data at the sparse update's width
        pool = None if bt.candidates is None else bt.candidates.shape[0] - bt.size
        width = _lane_orders(bt.size, self.dp, self.num_neg, pool)[1][0 if side == "user" else 1]
        if self._exchange is not None:
            return leaf, self._exchange.exchange_lookup(leaf, idx, self.mesh, wire_dtype=self.wire,
                                                        lanes=width)
        return leaf, self._lookup.sharded_lookup(leaf, idx, self.mesh, self.wire, width)

    def table_grad(self, grad, idx, table):
        return grad

    def weigh(self, batch, n_local, terms):
        return _shard_parts(batch, n_local, terms)

    def reduce_losses(self, terms):
        summed = self._pm.all_reduce(torch.stack(terms).detach(), self.mesh, self._pm.DATA_AXIS)
        return list(summed.unbind())

    def reduce_dense(self, grads):
        if not grads:
            return grads
        flat = self._pm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh, self._pm.DATA_AXIS)
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def reduce_table_sq(self, sq):
        return self._pm.all_reduce(sq.reshape(1), self.mesh, self._pm.MODEL_AXIS)[0]

    def tp(self, state):
        if not state.tensor_parallel:
            return None
        if self._tp is None:
            self._tp, self._split_at = self._tp_contexts(state.model)
        return self._tp

    def _tp_contexts(self, model: TwoTower):
        """Each tower's context over ``model`` (f, g and its layers' roles)
        and the positions of the split leaves in ``dense_parameters``. The
        roles follow the config's widths, so one build serves every state
        of the step."""
        pm, mesh, axis = self._pm, self.mesh, self._pm.MODEL_AXIS
        size = pm.axis_size(mesh, axis)
        base = TPContext(
            size=size, index=pm.axis_index(mesh, axis),
            copy_in=lambda t: pm.copy_to_axis(t, mesh, axis),
            reduce_out=lambda t: pm.all_reduce_statistic(t, mesh, axis),
            all_reduce=lambda t: pm.all_reduce(t, mesh, axis), roles={},
        )
        contexts = {side: base._replace(roles=model.tower(side).tp_roles(size))
                    for side in ("user", "item")}
        split = self._sharding.tp_leaf_dims(model, size)
        return contexts, [i for i, (key, _) in enumerate(model.dense_parameters()) if key in split]

    def dense_sq(self, grads, tp):
        sq = super().dense_sq(grads, tp)
        if tp is not None and self._split_at:
            # one sum over model of every split parameter's slice norm
            at = self._split_at
            summed = self._pm.all_reduce(torch.stack([sq[i] for i in at]), self.mesh, self._pm.MODEL_AXIS)
            for i, value in zip(at, summed.unbind()):
                sq[i] = value
        return sq

    def candidates(self, pos_emb, pool_emb, bt):
        pool = bt.candidates.shape[0] - bt.size
        return self._gathered(pos_emb, bt.size), self._gathered(pool_emb, pool)

    def _gathered(self, rows: torch.Tensor, total: int) -> torch.Tensor:
        """The ``[total, D]`` rows that the data shards hold in
        :func:`_data_shard` chunks, this rank's being ``rows``."""
        if total == 0 or self.dp == 1:
            return rows
        chunk = -(-total // self.dp)
        rows = torch.cat([rows, rows.new_zeros((chunk - rows.shape[0], rows.shape[1]))])
        full = self._pm.all_gather_rows_grad(rows, self.mesh, self._pm.DATA_AXIS)
        keep = _shard_rows(total, self.dp)
        return full if keep is None else full[self._on_device(("rows", total), keep, full.device)]

    def lanes(self, side, idx, grad, bt):
        """This rank's lanes padded to one length on every rank, and the
        permutation of the gathered lanes into the global order."""
        pool = None if bt.candidates is None else bt.candidates.shape[0] - bt.size
        orders, widths = _lane_orders(bt.size, self.dp, self.num_neg, pool)
        k = 0 if side == "user" else 1
        idx, grad = self._lookup.pad_lanes(idx, grad, widths[k])
        order = orders[k]
        if order is not None:
            order = self._on_device(("lanes", bt.size, pool, k), order, idx.device)
        return _Lanes(idx, grad, order)

    def sparse_sq(self, table, lanes):
        """The lanes of every data shard gathered and sorted once: the norm
        sums each run's total once, and the update reuses them."""
        gathered = self._update.gather_lanes(self.mesh, lanes.idx, lanes.grad, lanes.order)
        totals = torch.where(gathered.is_head[:, None], gathered.totals(), 0.0)
        return lanes._replace(gathered=gathered), torch.sum(torch.square(totals))

    def sparse_update(self, table, opt_state, lanes, tscfg, scalars):
        self._update.sharded_sparse_adam_apply(
            self.mesh, table, opt_state, lanes.idx, lanes.grad, scalars=scalars,
            decay=bool(tscfg.sparse_weight_decay), routing=tscfg.update_routing,
            capacity_factor=tscfg.update_capacity_factor, gather_order=lanes.order,
            gathered=lanes.gathered,
        )


def _layout(tscfg: TrainStepConfig, mesh) -> _OneDevice:
    return _OneDevice(tscfg) if mesh is None else _Mesh(mesh, tscfg)


def _batch_lanes(layout: _OneDevice, tscfg: TrainStepConfig, data, u_idx, pos_idx, generator,
                 negatives) -> _Batch:
    """This rank's users and item lanes of one batch (:class:`_Batch`)."""
    batch = u_idx.shape[0]
    u_idx, pos_idx = u_idx.to(torch.int32), pos_idx.to(torch.int32)
    lo, hi = layout.shard(batch)
    if tscfg.loss_type == "in_batch_softmax":
        pool = _pool(tscfg, u_idx.device, generator, negatives)
        plo, phi = layout.shard(pool.shape[0])
        items = torch.cat([pos_idx[lo:hi], pool[plo:phi]])
        return _Batch(batch, lo, hi, u_idx[lo:hi], items, torch.cat([pos_idx, pool]))
    neg_flat = _negatives(tscfg, data, u_idx, generator, negatives, layout.lookup)
    num_neg = tscfg.negatives_per_positive
    items = torch.cat([pos_idx[lo:hi], neg_flat[lo * num_neg : hi * num_neg]])
    return _Batch(batch, lo, hi, u_idx[lo:hi], items)


def step_scalars(state: TrainState, tscfg: TrainStepConfig, steps: int) -> np.ndarray:
    """The f32 ``[steps, DENSE_SCALARS + ADAM_SCALARS * tables]`` scalars of
    the next ``steps`` train steps from ``state``'s counts, each formed on
    the host in double and rounded once: row ``k`` holds step ``k + 1``'s
    dense optimizer scalars (``optim.dense_scalars``), then each sparse
    table's (``kernels.adam_scalars``, in ``sparse_table_names`` order, at
    the table's own count and the schedule's learning rate). A step reads
    its row from the device, so a step and a replay of a captured step run
    the same ops on the same values."""
    opt = tscfg.opt
    names = sparse_table_names(state.model.cfg)
    rows = np.empty((steps, DENSE_SCALARS + kernels.ADAM_SCALARS * len(names)), np.float32)
    for k in range(1, steps + 1):
        lr_t = opt.lr * lr_scale(opt, state.step + k)
        rows[k - 1, :DENSE_SCALARS] = dense_scalars(opt, state.opt_dense.step + k)
        for i, n in enumerate(names):
            lo = DENSE_SCALARS + i * kernels.ADAM_SCALARS
            rows[k - 1, lo : lo + kernels.ADAM_SCALARS] = kernels.adam_scalars(
                step=state.opt_sparse[n].step + k, lr=lr_t, b1=opt.b1, b2=opt.b2, eps=1e-8,
                weight_decay=tscfg.sparse_weight_decay,
            )
    return rows


def _advance(state: TrainState, steps: int) -> None:
    """The host counts after ``steps`` train steps: the state's, the dense
    optimizer's and each sparse table's."""
    state.step += steps
    state.opt_dense.step += steps
    for opt_state in state.opt_sparse.values():
        opt_state.step += steps


def _train_core(cfg: ModelConfig, tscfg: TrainStepConfig, mesh=None):
    """``core(state, data, u_idx, pos_idx, scalars, *, generator,
    negatives=None, dropout_generator=None) -> metrics``: one train step at
    the f32 ``scalars`` row of :func:`step_scalars` (on the device), the
    state updated in place and its host counts left as they are, so the
    same Python runs eagerly and under a CUDA graph capture."""
    _check_config(tscfg)
    layout = _layout(tscfg, mesh)
    sparse_names = sparse_table_names(cfg)
    dense_tbl_names = dense_table_names(cfg)
    opt = tscfg.opt
    lam_u = tscfg.lambda_mimic_user if cfg.mimic_enabled else 0.0
    lam_i = tscfg.lambda_mimic_item if cfg.mimic_enabled else 0.0
    lam_c = tscfg.lambda_category_alignment
    # model.precision: bfloat16: the towers leave each weight gradient of a
    # bf16 matmul in float32 (models/encoders.py _Bf16Dot); it is rounded
    # after the sum over data, where the JAX mesh step rounds it
    bf16 = cfg.user_tower.compute_dtype == "bfloat16"

    def combine(retrieval, mu, mi, cal):
        total = retrieval
        if lam_u > 0:
            total = total + lam_u * mu
        if lam_i > 0:
            total = total + lam_i * mi
        if cal is not None:
            total = total + lam_c * cal
        return total

    def core(state, data, u_idx, pos_idx, scalars, *, generator, negatives=None,
             dropout_generator=None):
        model, tp = state.model, layout.tp(state)
        bt = _batch_lanes(layout, tscfg, data, u_idx, pos_idx, generator, negatives)
        row_idx = _row_indices(bt)
        tables = state.tables
        inputs, rows = {}, {}
        for n, t in tables.items():
            if n in dense_tbl_names:
                inputs[n], rows[n] = layout.dense_table_rows(t, row_idx[n], n.split("_")[0], bt)
            else:
                inputs[n] = rows[n] = layout.table_rows(t, row_idx[n]).requires_grad_()

        user_emb, pos_emb, neg_emb, mu_loss, mi_loss = _forward_embeddings(
            model, tscfg, data, bt.users, bt.items, rows,
            layout.dropout(generator, dropout_generator), layout.lookup, tp,
        )
        retrieval = _retrieval_loss(layout, tscfg, data, bt, user_emb, pos_emb, neg_emb)
        parts = layout.weigh(bt.size, bt.hi - bt.lo, [retrieval, mu_loss, mi_loss])
        cal_loss = None
        if lam_c > 0 and data.category_ids is not None:
            cal_loss = category_alignment_loss(
                layout.lookup(data.category_ids, bt.items),
                torch.cat([pos_emb, neg_emb.reshape(-1, pos_emb.shape[-1])]),
                max_categories=tscfg.cal_max_categories, mesh=layout.mesh,
            )
        objective = combine(*parts, cal_loss)

        dense = [p for _, p in model.dense_parameters()]
        wrt = [*dense, *inputs.values()]
        grads = torch.autograd.grad(objective, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        dense_grads = layout.reduce_dense(grads[: len(dense)])
        if bf16:
            dense_grads = [g.to(torch.bfloat16).float() if k.endswith("/w") else g
                           for (k, _), g in zip(model.dense_parameters(), dense_grads)]
        input_grads = dict(zip(inputs, grads[len(dense) :]))
        table_grads = [layout.table_grad(input_grads[n], row_idx[n], tables[n]) for n in dense_tbl_names]
        lanes = {n: layout.lanes(n[:4], row_idx[n], input_grads[n], bt) for n in sparse_names}

        if tscfg.gradient_clip_norm is not None and tscfg.gradient_clip_norm > 0:
            # Global norm over every gradient, with each sparse table's
            # duplicate rows summed first (the true gradient's norm).
            sq = sum(layout.dense_sq(dense_grads, tp))
            if table_grads:
                sq = sq + layout.reduce_table_sq(sum(torch.sum(torch.square(g)) for g in table_grads))
            for n in sparse_names:
                lanes[n], table_sq = layout.sparse_sq(tables[n], lanes[n])
                sq = sq + table_sq
            scale = torch.clamp(tscfg.gradient_clip_norm / (torch.sqrt(sq) + 1e-6), max=1.0)
            dense_grads = [g * scale for g in dense_grads]
            table_grads = [g * scale for g in table_grads]
            lanes = {n: ln.scaled(scale) for n, ln in lanes.items()}
        lanes = {n: ln.on_wire(layout.wire) for n, ln in lanes.items()}

        dense_opt_apply(
            [t for _, t in state.dense_targets()], dense_grads + table_grads, state.opt_dense, opt,
            scalars[:DENSE_SCALARS],
        )
        for i, n in enumerate(sparse_names):
            lo = DENSE_SCALARS + i * kernels.ADAM_SCALARS
            layout.sparse_update(tables[n], state.opt_sparse[n], lanes[n], tscfg,
                                 scalars[lo : lo + kernels.ADAM_SCALARS])
        retrieval, mu, mi = layout.reduce_losses(parts)
        cal = None if cal_loss is None else cal_loss.detach()
        return {
            "loss": combine(retrieval, mu, mi, cal),
            "retrieval_loss": retrieval,
            "mimic_user_loss": mu,
            "mimic_item_loss": mi,
            "category_alignment_loss": retrieval.new_zeros(()) if cal is None else cal,
        }

    return core


def make_train_step(cfg: ModelConfig, tscfg: TrainStepConfig, *, mesh=None) -> TrainStep:
    """Build ``train_step(state, data, u_idx, pos_idx, *, generator,
    negatives=None, dropout_generator=None) -> (state, metrics)``.

    ``generator`` (on the data's device) draws the negatives (the in-batch
    loss: the pool of mixed negatives) and, on one device, the dropout
    masks unless ``dropout_generator`` is given; ``negatives`` ``[B, NEG]``
    (the in-batch loss: ``[M]``) replaces the draw (tests inject the JAX
    draws). The state is updated in place and
    returned; the metrics are 0-d device tensors (``loss`` and the four loss
    terms), read by the caller when it likes, so a step issues no host sync
    (its optimizer scalars, :func:`step_scalars`, reach the card through
    pinned memory without one).

    ``mesh``: the step on one rank of a ``(data, model)`` mesh, whose
    differences :class:`_Mesh` lists (dropout from ``dropout_generator``),
    with the dense tower layers split over ``model`` where the state was
    placed so (``TrainState.tensor_parallel``).
    """
    core = _train_core(cfg, tscfg, mesh)

    def train_step(state, data, u_idx, pos_idx, *, generator, negatives=None, dropout_generator=None):
        scalars = host_to_device(step_scalars(state, tscfg, 1)[0], u_idx.device)
        metrics = core(state, data, u_idx, pos_idx, scalars, generator=generator,
                       negatives=negatives, dropout_generator=dropout_generator)
        _advance(state, 1)
        return state, metrics

    return train_step


def make_eval_loss_step(
    cfg: ModelConfig, tscfg: TrainStepConfig, *, mesh=None
) -> Callable[..., torch.Tensor]:
    """Build ``eval_loss_step(state, data, u_idx, pos_idx, *, generator,
    negatives=None) -> loss``: the retrieval loss of the train step (the
    BCE on [positives; sampled negatives], or the in-batch softmax of the
    batch with its own pool), no dropout, no auxiliary terms (0-d device
    tensor). ``mesh``: the batch's loss from the data shards' parts
    (:class:`_Mesh` describes the layout; a tensor-parallel state as in the
    train step)."""
    _check_config(tscfg)
    layout = _layout(tscfg, mesh)
    sparse_names = sparse_table_names(cfg)

    @torch.no_grad()
    def eval_loss_step(state, data, u_idx, pos_idx, *, generator, negatives=None):
        bt = _batch_lanes(layout, tscfg, data, u_idx, pos_idx, generator, negatives)
        row_idx = _row_indices(bt)
        rows = {
            n: (layout.table_rows if n in sparse_names else layout.lookup)(t, row_idx[n])
            for n, t in state.tables.items()
        }
        user_emb, pos_emb, neg_emb, _, _ = _forward_embeddings(
            state.model, tscfg, data, bt.users, bt.items, rows, None, layout.lookup,
            layout.tp(state),
        )
        retrieval = _retrieval_loss(layout, tscfg, data, bt, user_emb, pos_emb, neg_emb)
        (loss,) = layout.reduce_losses(layout.weigh(bt.size, bt.hi - bt.lo, [retrieval]))
        return loss

    return eval_loss_step


# ---------------------------------------------------------------------------
# Many steps a call: CUDA-graph replays of one captured step
# ---------------------------------------------------------------------------


class _Graph(NamedTuple):
    """One captured step and its static buffers: the chunk's batches ``u``,
    ``p`` ``[cap, B]``, its scalar rows ``s`` ``[cap, n]`` (None for the
    eval loss), its losses ``loss`` ``[cap]`` and the device step counter
    ``ctr`` at which a replay reads its row and writes its loss; ``launches``:
    the port's kernel launches of one replay, by name; ``generators``: the
    registered generators, held so that their ids in the key stay their
    own; ``branches``: the graphs of the on-device branches
    (``ops/device_cond.py``) whose nodes it embeds."""

    graph: Any
    u: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor | None
    loss: torch.Tensor
    ctr: torch.Tensor
    launches: dict[str, int]
    generators: tuple
    branches: list


def _graph_key(state: TrainState, data: BatchData, u_all: torch.Tensor, generators: tuple) -> tuple:
    """What a captured step is bound to: the address, shape and dtype of
    every state and dataset tensor it reads or writes, the batch's shape and
    dtype, and the generators (the negatives' and, on a mesh, the dropout
    masks')."""
    tensors = [t for _, t in state.dense_targets()]
    tensors += list(state.tables.values()) + state.opt_dense.m + state.opt_dense.v
    for opt_state in state.opt_sparse.values():
        tensors += [opt_state.m, opt_state.v]
    tensors += [t for t in vars(data).values() if t is not None]
    return (
        tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors),
        tuple(u_all.shape[1:]), u_all.dtype, tuple(id(g) for g in generators),
    )


class _Replayer:
    """``run(state, data, u_all [K, B], p_all [K, B], scalars, generators)
    -> losses [K]``: K calls of ``body(state, data, u, p, scalars_row,
    generators) -> loss`` (a 0-d tensor), the step's state updates in
    place; ``generators``: the negatives' generator and the dropout masks'
    (or None).

    On the CPU, the loop of K calls. On a card, each call past the first is
    a replay of one CUDA graph of ``body``: the first call of a key
    (:func:`_graph_key`) runs its step eagerly, which builds the kernels,
    sets up cuBLAS and autograd and, on a ``mesh``, the communicators of
    every group (``parallel.mesh.warm_groups``) and the owner routing's
    branch graphs, then captures ``body`` reading its batch and scalar row
    from static buffers at a step counter on the device (registering each
    generator, whose draws then advance each replay as an eager step's
    would). On a mesh the collectives are captured with the rest; every
    rank captures and replays the same steps. A chunk is then one upload
    of its batches and scalar rows into the static buffers and one replay a
    step, with no host sync; the kernels' launch counts grow by the
    captured launches at each replay. A graph is captured again only for a
    key it was not captured for (a state or dataset tensor reallocated, as
    by a resume or a restore, another generator or batch shape) or a longer
    chunk. A capture or replay that fails raises: nothing falls back to
    eager steps."""

    KEEP = 2  # graphs held at once: the eval's val and test generators

    def __init__(self, body, mesh=None):
        self._body = body
        self._mesh = mesh
        self._graphs: dict[tuple, _Graph] = {}

    def run(self, state, data, u_all, p_all, scalars, generators) -> torch.Tensor:
        steps = u_all.shape[0]
        dev = u_all.device
        rows = None if scalars is None else host_to_device(scalars, dev)
        if dev.type != "cuda":
            return torch.stack([
                self._body(state, data, u_all[k], p_all[k], None if rows is None else rows[k],
                           generators)
                for k in range(steps)
            ])
        losses = torch.empty(steps, dtype=torch.float32, device=dev)
        key = _graph_key(state, data, u_all, generators)
        graph = self._graphs.get(key)
        start = 0
        if graph is None or graph.u.shape[0] < steps:
            if self._mesh is not None:
                from ..parallel.mesh import warm_groups

                warm_groups(self._mesh, dev)
            loss = self._body(state, data, u_all[0], p_all[0], None if rows is None else rows[0],
                              generators)
            losses[:1].copy_(loss.reshape(1))
            graph = self._capture(key, state, data, u_all, rows, generators)
            start = 1
        graph.u[:steps].copy_(u_all)
        graph.p[:steps].copy_(p_all)
        if rows is not None:
            graph.s[:steps].copy_(rows)
        graph.ctr.fill_(start)
        for _ in range(start, steps):
            graph.graph.replay()
        kernels.add_launch_counts(graph.launches, steps - start)
        losses[start:].copy_(graph.loss[start:steps])
        return losses

    def _capture(self, key, state, data, u_all, rows, generators) -> _Graph:
        self._graphs.pop(key, None)
        while len(self._graphs) >= self.KEEP:
            self._graphs.pop(next(iter(self._graphs)))
        dev = u_all.device
        steps = u_all.shape[0]
        u, p = torch.empty_like(u_all), torch.empty_like(u_all)
        s = None if rows is None else torch.empty_like(rows)
        loss_buf = torch.zeros(steps, dtype=torch.float32, device=dev)
        ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        graph = torch.cuda.CUDAGraph()
        registered = []
        for gen in generators:
            if gen is not None and all(gen is not g for g in registered):
                graph.register_generator_state(gen)
                registered.append(gen)
        before = kernels.launch_counts()
        try:
            # thread_local: the background checkpoint writer may use its own
            # stream meanwhile; a host sync in the step still raises
            with device_cond.holding() as branches, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                row = None if s is None else torch.index_select(s, 0, ctr)[0]
                loss = self._body(state, data, torch.index_select(u, 0, ctr)[0],
                                  torch.index_select(p, 0, ctr)[0], row, generators)
                loss_buf.index_copy_(0, ctr, loss.reshape(1).float())
                ctr.add_(1)
        finally:
            after = kernels.launch_counts()
            launches = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            kernels.add_launch_counts(launches, -1)  # captured, not run
        self._graphs[key] = _Graph(graph, u, p, s, loss_buf, ctr, launches, tuple(registered),
                                   list(branches))
        return self._graphs[key]


def make_multi_train_step(cfg: ModelConfig, tscfg: TrainStepConfig, *, mesh=None):
    """Build ``multi(state, data, u_all [K, B], p_all [K, B], *, generator,
    dropout_generator=None) -> (state, losses [K])``: K train steps of
    :func:`make_train_step` in one call (the JAX package's ``lax.scan`` of
    K steps, ``training.steps_per_call``), bit for bit the K single steps,
    the generators' draws included. The optimizers' scalars of the K steps
    are formed once on the host (:func:`step_scalars`) and uploaded once; on
    a card the steps past the first of a new state are replays of one
    captured step (:class:`_Replayer`), so the host issues a replay, not
    ~500 eager ops, a step. The state's host counts advance by K.

    ``mesh``: the K steps on one rank of a ``(data, model)`` mesh
    (``parallel.step.make_sharded_multi_train_step``), every rank calling
    with the same batches; its collectives are in the captured step."""
    core = _train_core(cfg, tscfg, mesh)
    replayer = _Replayer(
        lambda state, data, u, p, s, gens: core(
            state, data, u, p, s, generator=gens[0], dropout_generator=gens[1])["loss"],
        mesh,
    )

    def multi(state, data, u_all, p_all, *, generator, dropout_generator=None):
        losses = replayer.run(
            state, data, u_all, p_all, step_scalars(state, tscfg, u_all.shape[0]),
            (generator, dropout_generator),
        )
        _advance(state, u_all.shape[0])
        return state, losses

    return multi


def make_multi_eval_loss_step(cfg: ModelConfig, tscfg: TrainStepConfig, *, mesh=None):
    """Build ``multi(state, data, u_all [K, B], p_all [K, B], *, generator)
    -> losses [K]``: K eval-loss steps of :func:`make_eval_loss_step` in
    one call, as :func:`make_multi_train_step` (replays of one captured
    step on a card; one graph a generator, so a caller that re-seeds one
    generator object per split reuses it); ``mesh`` as there."""
    step = make_eval_loss_step(cfg, tscfg, mesh=mesh)
    replayer = _Replayer(
        lambda state, data, u, p, s, gens: step(state, data, u, p, generator=gens[0]), mesh)

    def multi(state, data, u_all, p_all, *, generator):
        return replayer.run(state, data, u_all, p_all, None, (generator,))

    return multi


@torch.no_grad()
def encode_corpus(
    model: TwoTower,
    side: str,
    features: torch.Tensor | None = None,
    *,
    chunk_size: int = 65536,
    num_rows: int | None = None,
) -> torch.Tensor:
    """Encode every user or item through its tower (+ mimic augmentation).

    Walks the rows in contiguous chunks of ``chunk_size`` on the model's
    device and returns f32 ``[num_rows, D]`` there. ``features`` is the
    side's ``[num_rows, F]`` feature matrix (or None / empty for an ID-only
    tower); chunks of it are moved to the model's device as they are used.
    ``num_rows`` (default: the side's users or items) encodes the first rows
    of the tables; a model shard passes its local row count.
    """
    tower = model.tower(side)
    table = tower.id_embedding.weight  # a sparse table ends in its scratch row
    dev = table.device
    n = tower.num_embeddings if num_rows is None else num_rows
    if features is not None and features.numel() == 0:
        features = None
    aug = model.mimic.table(side).weight if model.mimic is not None else None
    out = torch.empty((n, tower.cfg.output_dim), dtype=torch.float32, device=dev)
    for start in range(0, n, chunk_size):
        end = min(start + chunk_size, n)
        feats = None if features is None else features[start:end].to(dev)
        emb = tower.forward_rows(table[start:end], feats)
        if aug is not None:
            emb = emb + aug[start:end]
        out[start:end] = emb
    return out


# ---------------------------------------------------------------------------
# Lane bookkeeping of the sharded step
# ---------------------------------------------------------------------------


def _data_shard(batch: int, dp: int, d: int) -> tuple[int, int]:
    """Lanes ``[lo, hi)`` of the batch that data shard ``d`` takes:
    contiguous chunks of ``ceil(batch / dp)`` (the last ones may be short
    or empty)."""
    chunk = -(-batch // dp)
    lo = min(d * chunk, batch)
    return lo, min(lo + chunk, batch)


@functools.lru_cache(maxsize=64)
def _lane_orders(batch: int, dp: int, num_neg: int, pool: int | None):
    """``((user order, item order), (user width, item width))``: the lanes a
    rank contributes are padded to one width on every rank, and the orders
    permute the lanes gathered over ``data`` (rank-major) into the step's
    global lane order: users in batch order, items as [every positive;
    every negative] (``pool`` None: ``num_neg`` a positive, in its shard)
    or [every positive; the pool] (the in-batch loss: ``pool`` shared draws
    split over data as the batch is), padding lanes last. An order is None
    where the gather order is already the global one."""
    chunk = -(-batch // dp)
    extra = chunk * num_neg if pool is None else -(-pool // dp)
    user, pos, neg, user_pad, item_pad = [], [], [], [], []
    for d in range(dp):
        lo, hi = _data_shard(batch, dp, d)
        n = hi - lo
        if pool is None:
            e = n * num_neg
        else:
            plo, phi = _data_shard(pool, dp, d)
            e = phi - plo
        ub, ib = d * chunk, d * (chunk + extra)
        user.append(np.arange(ub, ub + n))
        user_pad.append(np.arange(ub + n, ub + chunk))
        pos.append(np.arange(ib, ib + n))
        neg.append(np.arange(ib + n, ib + n + e))
        item_pad.append(np.arange(ib + n + e, ib + chunk + extra))
    orders = (np.concatenate(user + user_pad), np.concatenate(pos + neg + item_pad))
    identity = lambda order: np.array_equal(order, np.arange(order.size))  # noqa: E731
    return tuple(None if identity(o) else o for o in orders), (chunk, chunk + extra)


@functools.lru_cache(maxsize=64)
def _shard_rows(total: int, dp: int) -> np.ndarray | None:
    """Where the ``total`` rows split in :func:`_data_shard` chunks sit
    among the chunks all-gathered over ``data`` (each padded to the chunk
    size); None where the chunks hold no padding."""
    chunk = -(-total // dp)
    if chunk * dp == total:
        return None
    return np.concatenate([
        np.arange(d * chunk, d * chunk + hi - lo)
        for d, (lo, hi) in enumerate(_data_shard(total, dp, d) for d in range(dp))
    ])


def _shard_parts(batch: int, n_local: int, terms: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each mean over this data shard weighted by its share of the batch, so
    the sum over data shards is the batch mean (an empty shard adds zero
    and keeps its graph, so every rank runs the same backward)."""
    weight = n_local / batch
    if n_local == 0:
        return [torch.nan_to_num(t) * 0.0 for t in terms]
    return [t * weight for t in terms]
