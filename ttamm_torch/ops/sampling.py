"""On-device negative sampling: uniform draws with masked re-draw rounds
(port of ``ttamm_tpu/ops/sampling.py``).

Each (user, positive) row draws ``num_negatives`` uniform item ids and
re-draws any that collide with the user's positive set, for a fixed number
of masked rounds (no data-dependent loop, no host sync). With
``num_items >> positives per user`` the chance that a collision survives R
rounds is ~(p / num_items)^R. The draws come from an explicit
``torch.Generator`` on the rows' device; they cannot reproduce JAX's
threefry bits, so the tests check properties, not values.
"""

from __future__ import annotations

import torch


def sample_negative_items(
    user_positive_rows: torch.Tensor,
    *,
    num_items: int,
    num_negatives: int,
    generator: torch.Generator,
    num_rounds: int = 8,
) -> torch.Tensor:
    """int32 ``[batch, num_negatives]`` negatives for a batch of users.

    ``user_positive_rows``: int ``[batch, cap]`` padded positive item ids of
    each row's user (the pad value is >= ``num_items``, so no draw matches
    it). ``generator`` must live on the rows' device.
    """
    if num_negatives <= 0:
        raise ValueError("num_negatives must be greater than zero.")
    if num_items <= 1:
        raise ValueError("num_items must be greater than one.")
    shape = (user_positive_rows.shape[0], num_negatives)
    dev = user_positive_rows.device

    def draw() -> torch.Tensor:
        return torch.randint(
            0, num_items, shape, generator=generator, device=dev, dtype=torch.int32
        )

    samples = draw()
    positives = user_positive_rows[:, None, :]
    for _ in range(num_rounds):
        collides = (samples[:, :, None] == positives).any(dim=-1)
        samples = torch.where(collides, draw(), samples)
    return samples
