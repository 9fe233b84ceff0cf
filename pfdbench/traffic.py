"""The one generator of every traffic mix: structured images and the requests
of a closed loop, all drawn from ``--seed``.

A mix (``traffic/<name>.json``) gives the request's shape (``batch``
images of ``size``^2, ``steps`` DDIM steps, the turbo ``phases``, the mode,
the guidance scale, a ``hint`` method or none), the entry it drives, how
many requests a traced run traces and the check's sample. At set-up
``pools`` draws ``POOL`` reference images and, for a hinted mix, ``POOL``
hint images; request ``i`` takes ``batch`` distinct references (and
one hint image each) from the pools and a start-latent seed, all from
``numpy.random.default_rng([seed, i])``, so that request i is the same in
every run of a seed whatever the window holds. Every request has the same
sizes; only the images and the seeds differ between seeds.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
POOL = 32


def load(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def hint_image(rng, size=512):
    """A structured hint image: a white rectangle and a grey bar on black,
    with faint noise (the smoke test's generator, at a drawn position)."""
    img = 0.02 * rng.random((size, size, 3), dtype=np.float32)
    s = size / 512
    y0, x0 = (rng.integers(96, 160, size=2) * s).astype(int)
    img[y0:y0 + int(256 * s), x0:x0 + int(224 * s)] = 1.0
    img[y0 + int(100 * s):y0 + int(140 * s), int(40 * s):int(480 * s)] = 0.5
    return img


def reference_image(rng, size=512):
    """A structured reference image: the same layout in drawn colours over a
    drawn background, with a second rectangle and faint noise."""
    img = rng.random(3).astype(np.float32) * 0.4 + 0.04 * rng.random((size, size, 3),
                                                                      dtype=np.float32)
    s = size / 512
    y0, x0 = (rng.integers(64, 192, size=2) * s).astype(int)
    img[y0:y0 + int(256 * s), x0:x0 + int(224 * s)] = rng.random(3)
    y1, x1 = (rng.integers(0, 320, size=2) * s).astype(int)
    img[y1:y1 + int(160 * s), x1:x1 + int(192 * s)] = rng.random(3)
    img[y0 + int(100 * s):y0 + int(140 * s), int(40 * s):int(480 * s)] = rng.random(3)
    return np.clip(img, 0.0, 1.0)


def pools(seed, traffic):
    """(references (P, S, S, 3), hints (P, S, S, 3) or None) float32 in [0, 1]."""
    rng = np.random.default_rng([int(seed), 1 << 20])
    size = traffic["size"]
    refs = np.stack([reference_image(rng, size) for _ in range(POOL)])
    hints = (np.stack([hint_image(rng, size) for _ in range(POOL)])
             if traffic.get("hint") else None)
    return refs, hints


def request(seed, i, traffic):
    """Request i of a run: {"refs": pool indices (batch), "hints": pool
    indices or None, "seed": the start latent's seed}."""
    rng = np.random.default_rng([int(seed), int(i)])
    refs = rng.choice(POOL, size=traffic["batch"], replace=False)
    hints = (rng.choice(POOL, size=traffic["batch"], replace=False)
             if traffic.get("hint") else None)
    return {"refs": refs, "hints": hints, "seed": int(rng.integers(0, 2 ** 31 - 1))}


def warmup_request(traffic):
    """The set-up's request: pool entries 0.. and seed 0 (its output is not
    kept)."""
    idx = np.arange(traffic["batch"]) % POOL
    return {"refs": idx, "hints": idx if traffic.get("hint") else None, "seed": 0}
