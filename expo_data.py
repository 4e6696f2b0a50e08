"""The Expo-shaped categorical data set that ``chip_smoke.py`` and
``profiling/profile_torch_iteration.py --categorical`` train the port on.

The shape of the Expo experiment (the reference's docs/Experiments.rst:112,
the airline data), cut from its 11M rows: six categorical columns (name,
categories; Origin and Dest Zipf-distributed) and two numerical ones,
DepTime and Distance.  Imports numpy only.
"""

from __future__ import annotations

import numpy as np

EXPO_CATS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
             ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
#: the ``categorical_feature`` parameter of the set: its first six columns
EXPO_CATEGORICAL = ",".join(str(i) for i in range(len(EXPO_CATS)))


def expo_like(rows: int, seed: int = 11):
    """Synthetic two-class data shaped like the Expo/airline set: per-
    category effects on a latent, DepTime and Distance terms and noise, the
    label its top 20%."""
    rng = np.random.RandomState(seed)
    cols, latent = [], np.zeros(rows)
    for _, n in EXPO_CATS:
        if n == 300:
            # Zipf: the 45 rarest fall past max_bin, into the last bin
            p = 1.0 / np.arange(1, n + 1) ** 1.5
            c = rng.choice(n, size=rows, p=p / p.sum())
        else:
            c = rng.randint(0, n, rows)
        latent += (rng.randn(n) * 0.4)[c]
        cols.append(c)
    dep = np.clip(np.round(rng.normal(1330, 480, rows)), 1, 2400)
    dist = np.round(np.exp(rng.normal(6.4, 0.6, rows)))
    latent += 0.0008 * (dep - 1330) + 0.2 * np.log(dist) + rng.randn(rows)
    y = (latent > np.quantile(latent, 0.8)).astype(np.float64)
    return np.column_stack(cols + [dep, dist]).astype(np.float64), y
