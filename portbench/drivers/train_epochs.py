"""Driver of the training mixes: whole epochs of the trainer's loop.

The mix file gives nothing but its name here: the batch, the steps a call
and the epochs come from the configuration (``training.batch_size``,
``training.steps_per_call``), as the trainer takes them. An epoch mirrors
``ttamm_torch/pipelines/training.py``'s loop without its eval and
checkpoint: a permutation of the train split drawn from the seed and
uploaded once, the full batches through ``make_multi_train_step`` in calls
of ``steps_per_call`` steps (``auto``: the trainer's rule, the whole epoch
at the canonical corpus), the remainder batch through ``make_train_step``,
then one read of the epoch's losses, which waits for the card.

Set-up builds one training state from the seed's initial weights
(``weights.py``) and runs one epoch on it, which captures the step's CUDA
graph and warms the remainder's shape. Then it puts the same state back to
the seed's weights in place (the graph keeps its tensors), with zero
moments, zero counts and the generator re-seeded, and drives it through
the first three steps of the epoch-0 order through the window's own call
(one step, then two): the losses, each leaf's first gradient (read from its
Adam first moment after one step) and each leaf's change after three are
the program's readings. The window continues from that state.

``train_examples_per_s``: every example of every step in the window over
the window's wall time; the window runs whole epochs and ends in the sync
after the epoch in which ``--seconds`` ran out.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from portbench import corpus, device_trace, weights, yardstick
from portbench.device_trace import span
from portbench.reference import compare
from portbench.reference import train_step as reference

COMPARED_STEPS = 3


def _lap(what: str, since: float) -> float:
    now = time.perf_counter()
    print(f"set-up: {what} in {now - since:.3f} s", flush=True)
    return now


def steps_per_call(raw, full: int, cap: int = 8192) -> int:
    """``training.steps_per_call``: an int, or ``auto``, the trainer's rule
    (the K <= ``cap`` that makes ``full // K`` calls plus ``full % K``
    single steps fewest)."""
    if raw not in (None, "auto"):
        return int(raw)
    if full <= 1:
        return max(full, 1)
    best_k, best = 1, full
    for k in range(2, min(cap, full) + 1):
        cost = full // k + full % k
        if cost < best:
            best_k, best = k, cost
    return best_k


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device: str, cache: Path):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.cfg = config["config"]
        self.dev = torch.device(device)
        self.cache = cache
        self.epoch = 0

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from ttamm_torch.models.two_tower import parse_model_config
        from ttamm_torch.pipelines.training import train_step_config
        from ttamm_torch.train.state import BatchData, create_train_state
        from ttamm_torch.train.step import make_multi_train_step, make_train_step

        tick = time.perf_counter()
        arrays = corpus.load(self.config, self.cache)
        tick = _lap("corpus loaded", tick)
        cfg, training = self.cfg, self.cfg["training"]
        self.train_users, self.train_items = arrays["train_users"], arrays["train_items"]
        num_users, num_items = arrays["positive_rows"].shape[0], arrays["category_ids"].shape[0]
        self.feature_dims = {"user": arrays["user_features"].shape[1], "item": arrays["item_features"].shape[1]}
        self.rows = {"user": num_users, "item": num_items}

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev) if a.size else None

        in_batch = str(training.get("loss", "bce")).lower() == "in_batch_softmax"
        self.data = dict(
            user_features=on_dev(arrays["user_features"]), item_features=on_dev(arrays["item_features"]),
            positive_rows=on_dev(arrays["positive_rows"]), category_ids=on_dev(arrays["category_ids"]),
            item_log_q=on_dev(arrays["item_log_q"]) if in_batch and training.get("logq_correction", True)
            else None,
            num_items=num_items, num_categories=arrays["num_categories"],
        )
        self.batch = int(training.get("batch_size", 512))
        n = len(self.train_users)
        self.full = n // self.batch
        self.k = steps_per_call(training.get("steps_per_call", "auto"), self.full)
        self.model_cfg = parse_model_config(cfg["model"], user_feature_dim=self.feature_dims["user"],
                                            item_feature_dim=self.feature_dims["item"])
        self.tscfg = train_step_config(
            cfg, num_items=num_items, num_categories=arrays["num_categories"],
            total_steps=-(-n // self.batch) * int(training.get("num_epochs", 1)))
        self.batch_data = BatchData(**{k: self.data[k] for k in (
            "user_features", "item_features", "positive_rows", "category_ids", "item_log_q")})
        self.state = create_train_state(self.model_cfg, num_users=num_users, num_items=num_items,
                                        seed=0, device=self.dev)
        self.multi = make_multi_train_step(self.model_cfg, self.tscfg)
        self.single = make_train_step(self.model_cfg, self.tscfg)
        self.gen = torch.Generator(device=self.dev)
        self.gen_seed = weights.stream_seed(self.seed, weights.STEPS)
        initial = self._initial()
        self._reset(initial)
        tick = _lap("state built", tick)
        self.run_epoch(0)  # captures the step's graph, warms the remainder's shape
        tick = _lap("warm-up epoch", tick)
        self._reset(initial)
        self.readings = self._first_steps(initial)
        _lap("first steps read", tick)

    def _initial(self) -> dict[str, torch.Tensor]:
        return weights.initial_weights(self.cfg["model"], self.rows, self.feature_dims, self.seed, self.dev)

    def _leaves(self) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """Each leaf of the program's state by the benchmark's name, with
        its Adam first moment."""
        state = self.state
        out = {}
        for (name, t), m in zip(state.dense_targets(), state.opt_dense.m):
            kind, key = name.split("/", 1)
            if kind == "dense":
                key = key[:-2] + ("/weight" if key.endswith("/w") else "/bias")
            out[key] = (t, m)
        for n, st in state.opt_sparse.items():
            out[n] = (state.tables[n], st.m)
        return out

    @torch.no_grad()
    def _reset(self, initial: dict[str, torch.Tensor]) -> None:
        """The state at the seed's weights, in place: zero moments and
        counts, the generator re-seeded."""
        leaves = self._leaves()
        if set(leaves) != set(initial):
            raise RuntimeError(f"leaves differ: program {sorted(leaves)}, benchmark {sorted(initial)}")
        for name, (t, _) in leaves.items():
            if t.shape != initial[name].shape:
                raise RuntimeError(f"{name}: program {tuple(t.shape)}, benchmark {tuple(initial[name].shape)}")
            t.copy_(initial[name])
        state = self.state
        for t in state.opt_dense.m + state.opt_dense.v:
            t.zero_()
        for st in state.opt_sparse.values():
            st.m.zero_()
            st.v.zero_()
            st.step = 0
        state.step = state.opt_dense.step = 0
        self.gen.manual_seed(self.gen_seed)

    def order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([weights.stream_seed(self.seed, weights.ORDER), epoch])
        return rng.permutation(len(self.train_users))

    def _batch(self, perm: np.ndarray, first: int, steps: int):
        rows = perm[first * self.batch : (first + steps) * self.batch]
        u = torch.from_numpy(self.train_users[rows]).to(self.dev).view(steps, self.batch)
        p = torch.from_numpy(self.train_items[rows]).to(self.dev).view(steps, self.batch)
        return u, p

    def _first_steps(self, initial: dict[str, torch.Tensor]) -> dict:
        perm = self.order(0)
        b1 = self.tscfg.opt.b1
        u, p = self._batch(perm, 0, 1)
        self.state, first = self.multi(self.state, self.batch_data, u, p, generator=self.gen)
        grad = {k: float(torch.linalg.vector_norm(m.detach().double())) / (1.0 - b1)
                for k, (_, m) in self._leaves().items()}
        u, p = self._batch(perm, 1, COMPARED_STEPS - 1)
        self.state, rest = self.multi(self.state, self.batch_data, u, p, generator=self.gen)
        change = {k: float(torch.linalg.vector_norm((t.detach() - initial[k]).double()))
                  for k, (t, _) in self._leaves().items()}
        losses = [float(x) for x in torch.cat([first, rest]).cpu()]
        return {"losses": losses, "grad": grad, "change": change}

    # -- the window ----------------------------------------------------------
    def run_epoch(self, epoch: int) -> np.ndarray:
        """One epoch of the trainer's loop; returns its losses (a sync)."""
        b, n = self.batch, len(self.train_users)
        with span("epoch.order"):
            perm = self.order(epoch)
            users = torch.from_numpy(self.train_users[perm]).to(self.dev)
            items = torch.from_numpy(self.train_items[perm]).to(self.dev)
        losses = []
        for first in range(0, self.full, self.k):
            steps = min(self.k, self.full - first)
            rows = slice(first * b, (first + steps) * b)
            with span("multi_train_step"):
                self.state, chunk = self.multi(self.state, self.batch_data, users[rows].view(steps, b),
                                               items[rows].view(steps, b), generator=self.gen)
            losses.append(chunk)
        for start in range(self.full * b, n, b):
            with span("train_step"):
                self.state, metrics = self.single(self.state, self.batch_data, users[start : start + b],
                                                  items[start : start + b], generator=self.gen)
            losses.append(metrics["loss"].reshape(1))
        with span("epoch.losses"):
            return torch.cat(losses).cpu().numpy()

    def steps_per_epoch(self) -> int:
        return self.full + (1 if len(self.train_users) % self.batch else 0)

    def window(self, seconds: float):
        steps = failed = examples = 0
        start = time.perf_counter()
        while True:
            self.epoch += 1
            losses = self.run_epoch(self.epoch)
            steps += len(losses)
            failed += int((~np.isfinite(losses)).sum())
            examples += len(self.train_users)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        return {"train_examples_per_s": examples / elapsed}, steps, failed

    def traced(self) -> device_trace.Trace:
        self.epoch += 1
        warm_perm = self.order(self.epoch)
        self.epoch += 1
        epoch = self.epoch

        def warm():
            u, p = self._batch(warm_perm, 0, min(8, self.full))
            self.multi(self.state, self.batch_data, u, p, generator=self.gen)

        def body():
            with device_trace.body_span():
                self.run_epoch(epoch)
                if self.dev.type == "cuda":
                    torch.cuda.synchronize()

        trace = device_trace.traced(warm, body, self.steps_per_epoch(), self.dev.type)
        n, b = len(self.train_users), self.batch
        sizes = [b] * self.full + ([n % b] if n % b else [])
        flops = sum(sum(yardstick.train_step_flops(self.cfg, self.feature_dims, s).values()) for s in sizes)
        in_batch = str(self.cfg["training"].get("loss", "bce")).lower() == "in_batch_softmax"
        neg = 0 if in_batch else int(self.cfg["training"].get("negatives_per_positive", 5))
        c = self.tscfg.cal_max_categories if self.tscfg.lambda_category_alignment > 0 else 0
        trace.info = {
            "kind": "train", "flops": flops,
            "dtype": "bfloat16" if self.model_cfg.user_tower.compute_dtype == "bfloat16" else "float32",
            "moments_rows": [s * (1 + neg) for s in sizes] if c else [],
            "dim": self.model_cfg.embedding_dim, "categories": c,
        }
        return trace

    # -- after the window ------------------------------------------------------
    def reference_batches(self) -> list:
        perm = self.order(0)
        return [tuple(t[0] for t in self._batch(perm, s, 1)) for s in range(COMPARED_STEPS)]

    def check(self) -> dict[str, float]:
        """The program's readings against the plain reference's, after the
        program's state is freed."""
        del self.state, self.multi, self.single, self.batch_data
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference.run(self.cfg, self._initial(), self.data, self.reference_batches(), self.gen_seed)
        print(f"check: leaves left out of change_gap: {compare.negligible(ref)}", flush=True)
        return compare.train_numbers(self.readings, ref)
