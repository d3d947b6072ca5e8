"""Tower encoders: ID embedding + feature MLP + fusion, as an ``nn.Module``
(port of ``ttamm_tpu/models/encoders.py``).

The config dataclasses and ``parse_tower_config`` follow the JAX package
rule for rule, so one YAML resolves to the same towers on both sides.
Supported fusions: identity / sum / concat(+projection) / gated (σ-gate
blend; ``adaptive_mimic`` is the deprecated alias for gated). Feature
encoders: identity / linear / MLP, with ``feature_encoder.dropout`` after
each hidden activation in training mode, drawn from an explicit
``torch.Generator`` (the JAX masks cannot be reproduced; tests run with
dropout off).

``model.precision: bfloat16`` (``compute_dtype``) runs every matmul of the
tower (the feature MLP, the gate's two layers, the concat projection) as
the JAX ``_dot``: bf16 operands, float32 sums and output, the bias added in
float32 after it (:func:`bf16_dot`). Its backward rounds as ``jax.grad`` of
``_dot`` does: each gradient is the float32 product of the float32
cotangent with the other operand's bf16 value, rounded to bf16 and widened;
the weight's gradient is left in float32 here and rounded by the train step
after its sum over the data shards, where the JAX mesh step's compiled HLO
rounds it (on one device the same bits). The weights stay float32, as in
the JAX package.

Tensor parallelism (``mesh.tensor_parallel``): with a :class:`TPContext`
the forward runs each linear layer of the feature MLP and the σ-gate in the
Megatron role the context gives it (:meth:`Tower.tp_roles`, from
:func:`tp_layer_roles`, a copy of the JAX function, which
``ttamm_torch.parallel.sharding`` reads too): a ``col`` layer holds rows
``[out/s]`` of ``weight`` and of ``bias`` and gives this rank's columns of
the output; its input passes the context's ``copy_in`` (Megatron's f: the
identity forward, a sum over ``model`` backward), so the input's gradient
is whole on every rank. A ``row`` layer holds columns ``[in/s]`` of
``weight``, multiplies this rank's columns of the input, sums the products
over ``model`` (``reduce_out``, g: the identity backward) and adds the
whole ``bias`` once, after the sum. A ``rep`` layer (and the concat
projection) is whole. Dropout after a ``col`` layer draws the whole
``[n, out]`` mask from the generator and keeps this rank's columns, so the
masks and the generator's stream are those of the forward without the
context. Under bfloat16 a ``col`` layer sums the input's float32 gradient
over ``model`` before its bf16 rounding, where the JAX TP step's compiled
HLO puts that sum.

Initialisation follows the JAX distributions (normal / uniform / xavier
tables, xavier-uniform weights with ±1/sqrt(fan_in) uniform biases), drawn
from an explicit ``torch.Generator``; it does not reproduce JAX's bits —
weights cross over through ``ttamm_torch.models.convert``.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "selu": F.selu,
}


class TPContext(NamedTuple):
    """Tensor parallelism of the dense tower layers over the ``model`` axis
    (the JAX ``TPContext``, whose collectives GSPMD inserted; here each is
    explicit). ``size`` / ``index``: the axis's extent and this rank's place
    on it. ``copy_in``: Megatron's f (identity forward, sum over the axis
    backward), a column-parallel layer's input. ``reduce_out``: g (sum over
    the axis forward, identity backward), a row-parallel layer's partial
    products. ``all_reduce``: the in-place sum over the axis, outside
    autograd (the bf16 column layer's input gradient). ``roles``: one
    tower's layer roles (:meth:`Tower.tp_roles`)."""

    size: int
    index: int
    copy_in: Callable[[torch.Tensor], torch.Tensor]
    reduce_out: Callable[[torch.Tensor], torch.Tensor]
    all_reduce: Callable[[torch.Tensor], torch.Tensor]
    roles: Mapping[str, str]


def tp_layer_roles(shapes: list[tuple[int, int]], size: int) -> list[str]:
    """Megatron role per linear layer of a stack, from each layer's
    ``(in, out)``: ``col`` / ``row`` / ``rep`` (a copy of the JAX
    ``tp_layer_roles``). A row layer always follows a col layer (its
    contraction dim is the col layer's sharded output); a layer whose
    output does not divide ``size`` at a col position, or the last layer
    of the stack, is replicated and the alternation restarts: a stack never
    ends column-parallel, since the tower output must be whole."""
    roles: list[str] = []
    after_col = False
    for i, (_, dout) in enumerate(shapes):
        if after_col:
            roles.append("row")
            after_col = False
        elif dout % size == 0 and i < len(shapes) - 1:
            roles.append("col")
            after_col = True
        else:
            roles.append("rep")
    return roles


@dataclass(frozen=True)
class EmbeddingConfig:
    dim: int = 64
    sparse: bool = False
    padding_idx: int | None = None
    max_norm: float | None = None
    init_type: str = "normal"
    init_std: float = 0.02
    init_bound: float = 0.1

    def __post_init__(self) -> None:
        if self.sparse and self.max_norm is not None:
            raise ValueError("max_norm is not supported when using sparse embeddings.")


@dataclass(frozen=True)
class FeatureEncoderConfig:
    type: str = "linear"
    output_dim: int | None = None
    hidden_dims: tuple[int, ...] = ()
    activation: str = "relu"
    dropout: float = 0.0


@dataclass(frozen=True)
class TowerConfig:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    feature_encoder: FeatureEncoderConfig | None = None
    fusion: str = "identity"
    output_dim: int = 0
    feature_dim: int = 0
    gate_hidden_dim: int | None = None
    compute_dtype: str = "float32"


def _parse_embedding_config(cfg: Mapping[str, Any] | None) -> EmbeddingConfig:
    cfg = cfg or {}
    params = cfg.get("params", {}) or {}
    init = cfg.get("init", {}) or {}
    return EmbeddingConfig(
        dim=int(params.get("embedding_dim", 64)),
        sparse=bool(params.get("sparse", False)),
        padding_idx=params.get("padding_idx"),
        max_norm=params.get("max_norm"),
        init_type=str(init.get("type", "normal")).lower(),
        init_std=float(init.get("std", 0.02)),
        init_bound=float(init.get("bound", 0.1)),
    )


def parse_tower_config(
    config: Mapping[str, Any] | None,
    *,
    feature_dim: int,
    compute_dtype: str = "float32",
) -> TowerConfig:
    """Resolve a YAML tower section into a TowerConfig (the JAX package's
    rules: fusion defaults to gated when features exist, feature towers
    without features degrade to identity, sum/gated need matching dims,
    concat gets a projection)."""
    cfg = dict(config or {})
    encoder_type = str(cfg.get("type", "tower")).lower()
    if encoder_type not in {"tower", "embedding"}:
        raise ValueError(f"Unsupported encoder type: {encoder_type}")

    if encoder_type == "embedding":
        emb = _parse_embedding_config(
            {"params": cfg.get("params", {}), "init": cfg.get("init")}
        )
        return TowerConfig(
            embedding=emb, fusion="identity", output_dim=emb.dim,
            compute_dtype=compute_dtype,
        )

    emb = _parse_embedding_config(cfg.get("id_embedding", {}))
    fusion = str(cfg.get("fusion", "gated" if feature_dim > 0 else "identity")).lower()
    if fusion == "adaptive_mimic":
        warnings.warn(
            "fusion='adaptive_mimic' is deprecated; use fusion='gated' instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        fusion = "gated"
    if fusion not in {"identity", "sum", "concat", "gated"}:
        raise ValueError(f"Unsupported fusion strategy: {fusion}")

    feature_encoder: FeatureEncoderConfig | None = None
    if feature_dim > 0:
        fe = dict(cfg.get("feature_encoder") or {})
        feature_encoder = FeatureEncoderConfig(
            type=str(fe.get("type", "linear")).lower(),
            output_dim=int(fe["output_dim"]) if fe.get("output_dim") is not None else None,
            hidden_dims=tuple(int(h) for h in (fe.get("hidden_dims") or ())),
            activation=str(fe.get("activation", "relu")).lower(),
            dropout=float(fe.get("dropout", 0.0)),
        )
        fe_out = feature_encoder.output_dim or emb.dim
        if feature_encoder.type == "identity" and feature_dim != fe_out:
            raise ValueError("Identity feature encoder requires input_dim == output_dim.")
        if fusion in {"sum", "gated"} and fe_out != emb.dim:
            raise ValueError(
                "Feature encoder output dimension must equal embedding dimension "
                "for 'sum' or 'gated' fusion."
            )
    else:
        fusion = "identity"

    if fusion == "concat":
        fe_out = feature_encoder.output_dim or emb.dim
        output_dim = int(cfg.get("output_dim") or (emb.dim + fe_out))
    else:
        output_dim = emb.dim

    gate_hidden = None
    if fusion == "gated":
        gate_hidden = (cfg.get("adaptive_mimic", {}) or {}).get("hidden_dim")
        gate_hidden = int(gate_hidden) if gate_hidden is not None else None

    return TowerConfig(
        embedding=emb,
        feature_encoder=feature_encoder,
        fusion=fusion,
        output_dim=output_dim,
        feature_dim=int(feature_dim),
        gate_hidden_dim=gate_hidden,
        compute_dtype=compute_dtype,
    )


# ---------------------------------------------------------------------------
# Initialisation (the JAX distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_embedding_(table: torch.Tensor, cfg: EmbeddingConfig, generator: torch.Generator) -> None:
    rows, dim = table.shape
    if cfg.init_type == "normal":
        table.normal_(0.0, cfg.init_std, generator=generator)
    elif cfg.init_type == "uniform":
        table.uniform_(-cfg.init_bound, cfg.init_bound, generator=generator)
    elif cfg.init_type in {"xavier_normal", "xavier_uniform"}:
        scale = math.sqrt(2.0 / (rows + dim))
        if cfg.init_type == "xavier_normal":
            table.normal_(0.0, scale, generator=generator)
        else:
            bound = math.sqrt(3.0) * scale
            table.uniform_(-bound, bound, generator=generator)
    else:
        raise ValueError(f"Unsupported embedding init type: {cfg.init_type}")
    if cfg.padding_idx is not None:
        table[int(cfg.padding_idx)] = 0.0


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Xavier-uniform weight, uniform ±1/sqrt(fan_in) bias."""
    fan_out, fan_in = layer.weight.shape
    bound_w = math.sqrt(6.0 / (fan_in + fan_out))
    layer.weight.uniform_(-bound_w, bound_w, generator=generator)
    bound_b = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    layer.bias.uniform_(-bound_b, bound_b, generator=generator)


def clamp_max_norm(rows: torch.Tensor, max_norm: float | None) -> torch.Tensor:
    """Functional max_norm on lookup: scale each gathered row to norm <=
    ``max_norm`` (the table itself is not changed)."""
    if max_norm is None:
        return rows
    norms = rows.norm(dim=-1, keepdim=True)
    return rows * torch.clamp(max_norm / norms.clamp_min(1e-12), max=1.0)


# ---------------------------------------------------------------------------
# bf16 matmuls (model.precision: bfloat16)
# ---------------------------------------------------------------------------


class _Bf16Dot(torch.autograd.Function):
    """``x @ weight.T`` with bf16 operands and float32 sums (the JAX
    ``_dot(x, w)`` at bfloat16, ``w = weight.T``). ``reduce_dx`` (a column
    layer under tensor parallelism) sums the input's float32 gradient over
    the model axis before its bf16 rounding.

    Forward: on the card one bf16 GEMM with float32 output
    (``torch.mm(..., out_dtype=torch.float32)``); on the CPU, which has no
    such GEMM, the float32 product of the operands rounded to bf16 and
    widened. A product of two bf16 values is exact in float32, so both
    equal the JAX ``_dot`` up to the order of the sums. On an H100 (700 W)
    at the default config's shapes the bf16 GEMM takes 0.0027-0.0132 ms a
    call against 0.0106-0.0367 for the widened form, 3.298 against 3.443
    device ms a train step (``scripts/bf16_dot_forms.py``). Backward, as
    the JAX transpose of ``dot_general(bf16, bf16, preferred f32)``
    followed by the ``astype`` that fed it: ``dx = f32(bf16(g @
    bf16(weight)))``, and ``dweight = gᵀ @ bf16(x)`` left in float32 for
    the train step, which sums it over the data shards and then rounds it
    to bf16 as JAX does; float32 products (the cotangent is float32).
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, reduce_dx=None) -> torch.Tensor:
        x16, w16 = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(x16, w16)
        ctx.reduce_dx = reduce_dx
        if x16.device.type == "cuda":
            return torch.mm(x16, w16.T, out_dtype=torch.float32)
        return x16.float() @ w16.float().T

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x16, w16 = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grad @ w16.float()
            if ctx.reduce_dx is not None:
                dx = ctx.reduce_dx(dx)
            dx = dx.to(torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            dw = grad.T @ x16.float()
        return dx, dw, None


def bf16_dot(x: torch.Tensor, weight: torch.Tensor, reduce_dx=None) -> torch.Tensor:
    """``x @ weight.T`` for rows ``x`` ``[N, in]`` and an ``nn.Linear``
    weight ``[out, in]``, on bf16 operands with float32 sums and output (see
    :class:`_Bf16Dot`)."""
    return _Bf16Dot.apply(x, weight, reduce_dx)


# ---------------------------------------------------------------------------
# Tower
# ---------------------------------------------------------------------------


class Tower(nn.Module):
    """One tower: ID table, optional feature encoder and fusion.

    ``forward`` takes row indices (and the matching feature rows);
    ``forward_rows`` takes already-gathered ID rows, like the JAX
    ``tower_forward``. ``extra_rows`` appends zero scratch rows to the ID
    table after its ``num_embeddings`` rows (the sparse-row optimizer's
    layout); they are never read.
    """

    def __init__(
        self,
        cfg: TowerConfig,
        num_embeddings: int,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
        extra_rows: int = 0,
    ) -> None:
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unsupported compute_dtype: {cfg.compute_dtype}")
        self.cfg = cfg
        self.num_embeddings = int(num_embeddings)
        dim = cfg.embedding.dim
        self.id_embedding = nn.Embedding(num_embeddings + extra_rows, dim, device=device)
        fe = cfg.feature_encoder
        self.feature_layers = nn.ModuleList()
        if fe is not None and cfg.feature_dim > 0:
            out_dim = fe.output_dim or dim
            if fe.type == "linear":
                widths = [cfg.feature_dim, out_dim]
            elif fe.type == "mlp":
                widths = [cfg.feature_dim, *fe.hidden_dims, out_dim]
            elif fe.type == "identity":
                widths = []
            else:
                raise ValueError(f"Unsupported feature encoder type: {fe.type}")
            for din, dout in zip(widths[:-1], widths[1:]):
                self.feature_layers.append(nn.Linear(din, dout, device=device))
        self.gate_fc1 = self.gate_fc2 = self.projection = None
        if cfg.fusion == "gated":
            hidden = cfg.gate_hidden_dim or dim
            self.gate_fc1 = nn.Linear(2 * dim, hidden, device=device)
            self.gate_fc2 = nn.Linear(hidden, dim, device=device)
        if cfg.fusion == "concat" and fe is not None:
            fe_out = fe.output_dim or dim
            self.projection = nn.Linear(dim + fe_out, cfg.output_dim, device=device)
        if generator is not None:
            self.reset_parameters(generator)
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        table = self.id_embedding.weight
        init_embedding_(table[: self.num_embeddings], self.cfg.embedding, generator)
        with torch.no_grad():
            table[self.num_embeddings :] = 0.0
        for _, layer in self.named_linears():
            init_linear_(layer, generator)

    def named_linears(self) -> list[tuple[str, nn.Linear]]:
        """Every linear layer with its JAX pytree path in the tower's dense
        parameters (``feature_encoder/layers/<i>``, ``gate/fc1``, ...)."""
        out = [(f"feature_encoder/layers/{i}", layer) for i, layer in enumerate(self.feature_layers)]
        extra = (("gate/fc1", self.gate_fc1), ("gate/fc2", self.gate_fc2),
                 ("projection", self.projection))
        return out + [(name, layer) for name, layer in extra if layer is not None]

    def tp_roles(self, size: int) -> dict[str, str]:
        """Each linear layer's tensor-parallel role at a model axis of
        ``size`` (:func:`tp_layer_roles` over the feature MLP, then over the
        gate's two layers; the projection stays whole), by
        :meth:`named_linears` path. The roles come from the layers' whole
        widths (``in_features`` / ``out_features``), which a rank's slices
        keep."""
        roles = {}
        if len(self.feature_layers):
            shapes = [(layer.in_features, layer.out_features) for layer in self.feature_layers]
            roles.update({f"feature_encoder/layers/{i}": role
                          for i, role in enumerate(tp_layer_roles(shapes, size))})
        if self.gate_fc1 is not None:
            gate = [(layer.in_features, layer.out_features) for layer in (self.gate_fc1, self.gate_fc2)]
            roles["gate/fc1"], roles["gate/fc2"] = tp_layer_roles(gate, size)
        if self.projection is not None:
            roles["projection"] = "rep"
        return roles

    def _dense(self, name: str, layer: nn.Linear, x: torch.Tensor,
               tp: TPContext | None = None) -> torch.Tensor:
        """The layer ``name`` (:meth:`named_linears`), in ``compute_dtype``
        (the JAX ``_dot(x, w) + b``), in its tensor-parallel role under
        ``tp`` (see the module docstring)."""
        bf16 = self.cfg.compute_dtype == "bfloat16"
        role = "rep" if tp is None else tp.roles[name]
        if role == "rep":
            return bf16_dot(x, layer.weight) + layer.bias if bf16 else layer(x)
        if role == "col":
            if bf16:
                return bf16_dot(x, layer.weight, tp.all_reduce) + layer.bias
            return F.linear(tp.copy_in(x), layer.weight, layer.bias)
        partial = bf16_dot(x, layer.weight) if bf16 else F.linear(x, layer.weight)
        return tp.reduce_out(partial) + layer.bias

    def feature_repr(
        self, features: torch.Tensor, generator: torch.Generator | None = None,
        tp: TPContext | None = None,
    ) -> torch.Tensor:
        """The feature MLP; in training mode, with a ``generator``, inverted
        dropout after each hidden activation (the JAX ``_apply_mlp``)."""
        fe = self.cfg.feature_encoder
        act = _ACTIVATIONS[fe.activation]
        drop = self.training and fe.dropout > 0.0 and generator is not None
        x = features
        last = len(self.feature_layers) - 1
        for i, layer in enumerate(self.feature_layers):
            name = f"feature_encoder/layers/{i}"
            x = self._dense(name, layer, x, tp)
            if i < last:
                x = act(x)
                if drop:
                    keep = torch.rand(
                        (x.shape[0], layer.out_features), generator=generator, device=x.device
                    ) < (1.0 - fe.dropout)
                    if tp is not None and tp.roles[name] == "col":  # this rank's columns
                        keep = keep[:, tp.index * x.shape[1] : (tp.index + 1) * x.shape[1]]
                    x = torch.where(keep, x / (1.0 - fe.dropout), 0.0)
        return x

    def gate_values(self, id_repr: torch.Tensor, feat_repr: torch.Tensor,
                    tp: TPContext | None = None) -> torch.Tensor:
        """σ(MLP([id; feat])): 1.0 blends all-ID, 0.0 all-feature."""
        h = self._dense("gate/fc1", self.gate_fc1, torch.cat([id_repr, feat_repr], dim=-1), tp)
        return torch.sigmoid(self._dense("gate/fc2", self.gate_fc2, F.relu(h), tp))

    def apply_gate(self, id_repr: torch.Tensor, feat_repr: torch.Tensor,
                   tp: TPContext | None = None) -> torch.Tensor:
        """σ-gate blend ``g * id + (1 - g) * feat``."""
        gate = self.gate_values(id_repr, feat_repr, tp)
        return gate * id_repr + (1.0 - gate) * feat_repr

    def forward_rows(
        self,
        id_rows: torch.Tensor,
        features: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
        tp: TPContext | None = None,
    ) -> torch.Tensor:
        """Tower output from gathered ID rows; ``generator`` draws the
        dropout masks in training mode; ``tp``: this rank's slices of the
        layers under tensor parallelism."""
        cfg = self.cfg
        id_rows = clamp_max_norm(id_rows, cfg.embedding.max_norm)
        if cfg.fusion == "identity" or cfg.feature_encoder is None or features is None:
            return id_rows
        feat = self.feature_repr(features.to(id_rows.dtype), generator, tp)
        if cfg.fusion == "sum":
            return id_rows + feat
        if cfg.fusion == "concat":
            return self._dense("projection", self.projection, torch.cat([id_rows, feat], dim=-1), tp)
        return self.apply_gate(id_rows, feat, tp)

    def forward(
        self, indices: torch.Tensor, features: torch.Tensor | None = None
    ) -> torch.Tensor:
        return self.forward_rows(self.id_embedding(indices), features)


@torch.no_grad()
def tower_gate_values(
    tower: Tower, id_rows: torch.Tensor, features: torch.Tensor | None
) -> torch.Tensor | None:
    """The σ-gate's values ``[N, D]`` on gathered ID rows and their feature
    rows, without dropout (the JAX ``tower_gate_values``); None when the
    tower does not blend by a gate (fusion other than ``gated``, or no
    features)."""
    cfg = tower.cfg
    if cfg.fusion != "gated" or cfg.feature_encoder is None or features is None:
        return None
    id_rows = clamp_max_norm(id_rows, cfg.embedding.max_norm)
    feat = tower.feature_repr(features.to(id_rows.dtype))
    return tower.gate_values(id_rows, feat)
