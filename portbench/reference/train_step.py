"""The plain reference of a training cell's step: the two towers with their
σ-gates and dropout, the adaptive mimic tables and their losses, the
retrieval loss (BCE over sampled negatives, or the logQ-corrected in-batch
softmax), the category-alignment regulariser, autograd, then dense AdamW
and sparse-row Adam, in plain float32 PyTorch. It imports nothing of the
program.

It follows the configuration (the YAML ``model`` and ``training``
sections) and draws what the step draws from one ``torch.Generator`` seeded
as the program's, in the program's order and shapes, so both sample the
same negatives and dropout masks: first the negatives (a uniform draw, then
8 masked re-draw rounds against the user's positives), then the user
tower's masks, then the item tower's. Two departures from plain float32,
both the op's stated definition in the configuration's package: the
category second moments are sums of products of bf16-rounded rows (summed
here in float64, rounded once), and their backward multiplies the
bf16-rounded ``G + G^T`` by the bf16-rounded rows.

``tf32=True`` runs every float32 matmul in TF32 (the control: the nearest
precision below the configuration's float32 with TF32 off).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

ACTIVATIONS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "tanh": torch.tanh,
               "selu": F.selu}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class _SecondMoments(torch.autograd.Function):
    """``M2[c] = sum over rows of category c of bf16(x) bf16(x)^T``, its
    backward ``dx = bf16(G + G^T) bf16(x)``; categories outside ``[0, c)``
    dropped."""

    @staticmethod
    def forward(ctx, key, x, c):
        ctx.save_for_backward(key, x)
        ctx.c = c
        xb = x.to(torch.bfloat16).double()
        m2 = x.new_zeros((c, x.shape[1], x.shape[1]), dtype=torch.float64)
        for cat in range(c):
            rows = xb[key == cat]
            if rows.shape[0]:
                m2[cat] = rows.T @ rows
        return m2.float()

    @staticmethod
    def backward(ctx, grad):
        key, x = ctx.saved_tensors
        h = (grad + grad.transpose(-1, -2)).to(torch.bfloat16).double()
        xb = x.to(torch.bfloat16).double()
        dx = torch.zeros_like(xb)
        for cat in range(ctx.c):
            sel = key == cat
            if sel.any():
                dx[sel] = xb[sel] @ h[cat]
        return None, dx.float(), None


def category_alignment(cat_ids, x, c):
    key = torch.where((cat_ids >= 0) & (cat_ids < c), cat_ids.long(), c)
    counts = torch.zeros(c + 1, device=x.device).index_add_(0, key, torch.ones_like(x[:, 0]))[:c]
    sums = torch.zeros(c + 1, x.shape[1], device=x.device).index_add(0, key, x)[:c]
    m2 = _SecondMoments.apply(key, x, c)
    n = counts.clamp_min(1.0)
    means = sums / n[:, None]
    covs = (m2 - counts[:, None, None] * means[:, :, None] * means[:, None, :]) \
        / (counts - 1.0).clamp_min(1.0)[:, None, None]
    covs = torch.where((counts > 1.0)[:, None, None], covs, 0.0)
    contribs = ((covs - covs[0][None]) ** 2).sum(dim=(1, 2))
    use = (counts >= 2.0) & (torch.arange(c, device=x.device) != 0)
    compared = use.sum()
    loss = torch.where(use, contribs, 0.0).sum() / compared.clamp_min(1)
    return torch.where((counts[0] >= 2.0) & (compared > 0), loss, 0.0)


def sample_negatives(positive_rows, num_items, num_negatives, gen, rounds):
    shape = (positive_rows.shape[0], num_negatives)

    def draw():
        return torch.randint(0, num_items, shape, generator=gen, device=positive_rows.device,
                             dtype=torch.int32)

    samples = draw()
    for _ in range(rounds):
        collides = (samples[:, :, None] == positive_rows[:, None, :]).any(dim=-1)
        samples = torch.where(collides, draw(), samples)
    return samples


def tower(side, enc, params, id_rows, feats, gen):
    fe = enc.get("feature_encoder") or {}
    if feats is None or not fe:
        return id_rows
    act = ACTIVATIONS[fe.get("activation", "relu")]
    p = float(fe.get("dropout", 0.0))
    x = feats
    names = sorted({k.rsplit("/", 1)[0] for k in params if k.startswith(f"{side}_tower/feature_encoder/")},
                   key=lambda k: int(k.rsplit("/", 1)[1]))
    for i, name in enumerate(names):
        w = params[f"{name}/weight"]
        x = F.linear(x, w, params[f"{name}/bias"])
        if i < len(names) - 1:
            x = act(x)
            if p > 0.0:
                keep = torch.rand((x.shape[0], w.shape[0]), generator=gen, device=x.device) < (1.0 - p)
                x = torch.where(keep, x / (1.0 - p), 0.0)
    if enc.get("fusion", "gated") not in ("gated", "adaptive_mimic"):
        raise NotImplementedError(f"fusion {enc.get('fusion')!r}: only the gated towers are written")
    g = f"{side}_tower/gate"
    h = F.linear(torch.cat([id_rows, x], dim=-1), params[f"{g}/fc1/weight"], params[f"{g}/fc1/bias"])
    gate = torch.sigmoid(F.linear(F.relu(h), params[f"{g}/fc2/weight"], params[f"{g}/fc2/bias"]))
    return gate * id_rows + (1.0 - gate) * x


def in_batch_softmax(user_emb, pos_emb, pos_idx, log_q, temperature):
    logits = user_emb @ pos_emb.T
    if temperature != 1.0:
        logits = logits / temperature
    if log_q is not None:
        logits = logits - log_q[None, :]
    n = logits.shape[0]
    diag = torch.eye(n, dtype=torch.bool, device=logits.device)
    hit = pos_idx[None, :] == pos_idx[:, None]
    logits = logits.masked_fill(hit & ~diag, torch.finfo(logits.dtype).min)
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def bce(logits, labels):
    x = logits
    return torch.mean(torch.clamp(x, min=0.0) - x * labels + torch.log1p(torch.exp(-x.abs())))


def run(config: dict, weights: dict, data: dict, batches: list, gen_seed: int, *,
        tf32: bool = False) -> dict:
    """Train ``weights`` (left as they are) for ``len(batches)`` steps on
    ``batches`` (``[(users, items)]``, int tensors on the data's device).

    ``data``: ``user_features``, ``item_features``, ``positive_rows``,
    ``category_ids``, ``item_log_q`` (device tensors) and ``num_items``,
    ``num_categories``. Returns each step's loss, each leaf's first
    gradient norm (the table-shaped gradient of a table, duplicate rows
    summed) and each leaf's change norm after the last step."""
    model, training = config["model"], config["training"]
    dev = data["positive_rows"].device
    p = {k: v.detach().clone() for k, v in weights.items()}
    dense_names = [k for k in p if "/" in k]
    mimic = model.get("adaptive_mimic") or {}
    mimic_on = bool(mimic.get("enabled", True))
    sparse = {f"{s}_id" for s in ("user", "item")
              if model[f"{s}_encoder"]["id_embedding"]["params"].get("sparse", False)}
    if mimic_on and mimic.get("sparse", False):
        sparse |= {"user_aug", "item_aug"}
    tables = [k for k in ("user_id", "item_id", "user_aug", "item_aug") if k in p]
    dense_targets = dense_names + [t for t in tables if t not in sparse]
    loss_type = str(training.get("loss", "bce")).lower()
    weights_cfg = training.get("loss_weights") or {}
    lam_u = float(weights_cfg.get("mimic_user", 0.0)) if mimic_on else 0.0
    lam_i = float(weights_cfg.get("mimic_item", 0.0)) if mimic_on else 0.0
    lam_c = float(weights_cfg.get("category_alignment", 0.0))
    nc = data["num_categories"]
    c = int(training.get("category_alignment_max_categories", min(64, -(-nc // 8) * 8) if nc else 0))
    neg = int(training.get("negatives_per_positive", 5))
    lr, wd = float(training.get("learning_rate", 1e-3)), float(training.get("weight_decay", 0.0))
    b1, b2 = (float(b) for b in training.get("betas", (0.9, 0.999)))
    eps = 1e-8
    adamw = str(training.get("optimizer", "adam")).lower() == "adamw"
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    start = {k: t.clone() for k, t in p.items()}
    losses, first_grad = [], None
    with matmul_precision(tf32):
        for step, (u, pos) in enumerate(batches, start=1):
            b = u.shape[0]
            if loss_type == "bce":
                negs = sample_negatives(data["positive_rows"][u.long()], data["num_items"], neg, gen, 8)
                items = torch.cat([pos.int(), negs.reshape(-1)])
            else:
                items = pos.int()
            lanes = {"user_id": u, "user_aug": u, "item_id": items, "item_aug": items}
            rows = {t: p[t][lanes[t].long()].requires_grad_() for t in tables}
            params = {k: p[k].clone().requires_grad_() for k in dense_names}
            feats_u = data["user_features"][u.long()] if data["user_features"] is not None else None
            feats_i = data["item_features"][items.long()] if data["item_features"] is not None else None
            user_base = tower("user", model["user_encoder"], params, rows["user_id"], feats_u, gen)
            item_base = tower("item", model["item_encoder"], params, rows["item_id"], feats_i, gen)
            pos_base, neg_base = item_base[:b], item_base[b:]
            if mimic_on:
                mu = torch.mean((rows["user_aug"] - pos_base.detach()) ** 2)
                mi = torch.mean((rows["item_aug"][:b] - user_base.detach()) ** 2)
                user_emb = user_base + rows["user_aug"]
                pos_emb = pos_base + rows["item_aug"][:b]
                neg_emb = neg_base + rows["item_aug"][b:]
            else:
                mu = mi = user_base.new_zeros(())
                user_emb, pos_emb, neg_emb = user_base, pos_base, neg_base
            if loss_type == "bce":
                neg3 = neg_emb.reshape(b, neg, -1)
                pos_logits = (user_emb * pos_emb).sum(-1)
                neg_logits = torch.einsum("bd,bnd->bn", user_emb, neg3).reshape(-1)
                logits = torch.cat([pos_logits, neg_logits])
                labels = torch.cat([torch.ones_like(pos_logits), torch.zeros_like(neg_logits)])
                retrieval = bce(logits, labels)
            else:
                log_q = None
                if training.get("logq_correction", True) and data["item_log_q"] is not None:
                    log_q = data["item_log_q"][pos.long()]
                retrieval = in_batch_softmax(user_emb, pos_emb, pos.long(), log_q,
                                             float(training.get("softmax_temperature", 1.0)))
            total = retrieval
            if lam_u > 0:
                total = total + lam_u * mu
            if lam_i > 0:
                total = total + lam_i * mi
            if lam_c > 0 and data["category_ids"] is not None:
                x = torch.cat([pos_emb, neg_emb.reshape(-1, pos_emb.shape[-1])])
                total = total + lam_c * category_alignment(data["category_ids"][items.long()], x, c)
            wrt = [params[k] for k in dense_names] + [rows[t] for t in tables]
            grads = torch.autograd.grad(total, wrt, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
            g = dict(zip(dense_names, grads[: len(dense_names)]))
            for t, lane_grad in zip(tables, grads[len(dense_names):]):
                g[t] = torch.zeros_like(p[t]).index_add_(0, lanes[t].long(), lane_grad)
            losses.append(float(total.detach()))
            if first_grad is None:
                first_grad = {k: float(torch.linalg.vector_norm(t.double())) for k, t in g.items()}
            with torch.no_grad():
                bc1, bc2 = 1.0 - b1**step, 1.0 - b2**step
                for k in dense_targets:
                    if adamw and wd:
                        p[k].mul_(1.0 - lr * wd)
                    m[k].mul_(b1).add_(g[k], alpha=1.0 - b1)
                    v[k].mul_(b2).addcmul_(g[k], g[k], value=1.0 - b2)
                    p[k].add_((m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps), alpha=-lr)
                for t in tables:
                    if t not in sparse:
                        continue
                    touched = torch.unique(lanes[t].long())
                    gt = g[t][touched]
                    mt = m[t][touched].mul_(b1).add_(gt, alpha=1.0 - b1)
                    vt = v[t][touched].mul_(b2).addcmul_(gt, gt, value=1.0 - b2)
                    m[t][touched], v[t][touched] = mt, vt
                    p[t][touched] = p[t][touched] - lr * (mt / bc1) / (torch.sqrt(vt / bc2) + eps)
    change = {k: float(torch.linalg.vector_norm((p[k] - start[k]).double())) for k in p}
    return {"losses": losses, "grad": first_grad, "change": change}
