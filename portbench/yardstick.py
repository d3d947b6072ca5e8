"""The benchmark's yardstick: the card's peaks, and the operations and bytes
the measured work needs, counted from shapes.

Frozen here so that a change to the program cannot move them. The peaks are
NVIDIA's data sheet for one H100 SXM (dense rates, no sparsity, at the full
700 W): 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, and
67 TFLOP/s in float32 outside them, which is the rate of a float32
configuration with TF32 off (``chip_smoke.py`` divided every operation by the
bf16 peak; that holds for bytes and for bf16 work only).

Every count is what the algorithm needs from its shapes, whatever implements
it: each input byte read once, each output byte written once, and the
multiply-adds of the products (two operations each).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, flops: float = 0.0, dtype: str = "bfloat16") -> tuple[float, str]:
    """Least time on the card in ms: bytes over the HBM bandwidth or
    operations over the ``dtype`` peak, whichever is larger, and which."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def linear_widths(feature_dim: int, tower: dict) -> list[tuple[int, int, bool]]:
    """``(in, out, needs_input_grad)`` of each matmul of one tower (the
    YAML ``user_encoder`` / ``item_encoder`` section): the feature MLP, then
    the σ-gate's two layers over ``[id; feat]``. The MLP's first layer takes
    the feature rows, which are not trained, so its input needs no
    gradient."""
    dim = int(tower["id_embedding"]["params"]["embedding_dim"])
    fe = tower.get("feature_encoder") or {}
    out = []
    if fe and feature_dim > 0:
        kind = fe.get("type", "mlp")
        out_dim = int(fe.get("output_dim") or dim)
        if kind == "mlp":
            widths = [feature_dim, *[int(h) for h in fe.get("hidden_dims", [])], out_dim]
        elif kind == "linear":
            widths = [feature_dim, out_dim]
        else:
            widths = []
        out += [(a, b, i > 0) for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
        if tower.get("fusion", "gated") in ("gated", "adaptive_mimic"):
            hidden = int(tower.get("gate_hidden_dim") or dim)
            out += [(2 * dim, hidden, True), (hidden, dim, True)]
    return out


def tower_flops(rows: int, widths: list[tuple[int, int, bool]]) -> float:
    """Forward and backward matmul operations of ``rows`` rows through one
    tower: the forward product, the weight gradient, and the input gradient
    where it is needed."""
    total = 0.0
    for din, dout, input_grad in widths:
        per = 2.0 * rows * din * dout
        total += per * (3 if input_grad else 2)
    return total


def moments_flops(n: int, d: int) -> float:
    """The category second moments: ``M2 = sum x x^T`` over ``n`` rows of
    width ``d`` (forward) and ``dx = (G + G^T) x`` (backward)."""
    return 2.0 * 2.0 * n * d * d


def moments_bytes(n: int, d: int, c: int) -> float:
    """Forward: read x [n, d] f32 and the int32 ids, write M2 [c, d, d] f32;
    backward: read gM2 [c, d, d] and x, write dx [n, d]."""
    x = 4.0 * n * d
    m2 = 4.0 * c * d * d
    return (x + 4.0 * n + m2) + (m2 + x + x)


def train_step_flops(cfg: dict, feature_dims: dict, batch: int) -> dict[str, float]:
    """Model operations of one train step of ``batch`` users, by part, from
    the YAML config's widths: ``towers`` (forward and backward matmuls of
    both towers and their gates), ``loss`` (the retrieval loss's products,
    forward and both gradients), ``moments`` (category alignment). Under
    BCE the item tower takes the positives and ``negatives_per_positive``
    negatives a user; under the in-batch softmax the positives, and the
    loss is a ``[B, B + M]`` logit matrix."""
    model, training = cfg["model"], cfg["training"]
    dim = int(model["user_encoder"]["id_embedding"]["params"]["embedding_dim"])
    in_batch = str(training.get("loss", "bce")).lower() == "in_batch_softmax"
    pool = int(training.get("mixed_negatives", 0)) if in_batch else 0
    neg = 0 if in_batch else int(training.get("negatives_per_positive", 5))
    item_rows = batch + pool if in_batch else batch * (1 + neg)
    towers = tower_flops(batch, linear_widths(feature_dims["user"], model["user_encoder"]))
    towers += tower_flops(item_rows, linear_widths(feature_dims["item"], model["item_encoder"]))
    logits = batch * (batch + pool) if in_batch else batch * (1 + neg)
    loss = 3 * 2.0 * logits * dim
    weights = training.get("loss_weights") or {}
    moments = moments_flops(item_rows, dim) if float(weights.get("category_alignment", 0)) > 0 else 0.0
    return {"towers": towers, "loss": loss, "moments": moments}


def search_flops(batch: int, items: int, dim: int) -> float:
    """One exact search: every query against every item, ``2 B N D``."""
    return 2.0 * batch * items * dim
