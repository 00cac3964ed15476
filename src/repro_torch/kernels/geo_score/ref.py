"""Plain PyTorch version of the geo_score kernel (same arithmetic order).

Slot by slot ``acc + (w*h)*qa`` over the ``Q_MAX`` zero-padded query rects,
then ``× amp`` — the kernel's order, so on the card the two agree bitwise.
``geo_score_toeprints_live_ref``, a test aid, sums the way the card's
kernel does (live slots only) and is held bitwise to the all-slot version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.geo_score.kernel import Q_MAX
from repro_torch.kernels.sweep_score.ref import _slot_term, live_slots


def geo_score_toeprints_ref(
    rects: torch.Tensor,  # f32[B, T, 4]
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4] (zero padded)
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
) -> torch.Tensor:
    """out[b, t] = amp[b, t] · Σ_j area(rect[b, t] ∩ q[b, j]) · q_amp[b, j]."""
    x0, y0, x1, y1 = rects.float().unbind(-1)
    acc = torch.zeros_like(x0)
    for j in range(Q_MAX):
        acc = _slot_term(acc, x0, y0, x1, y1, q_rects[:, None, j], q_amps[:, j, None])
    return acc * amps.float()


def geo_score_toeprints_live_ref(
    rects: torch.Tensor,  # f32[B, T, 4]
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4] (zero padded)
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
) -> torch.Tensor:
    """Test aid: :func:`geo_score_toeprints_ref` with the card's loop —
    each row sums its live slots only (``live_slots``), in slot order, and
    a row with none sums slot 0 alone (where a store coordinate is NaN,
    every slot's term is NaN, dead ones too).  Bitwise equal to the
    all-slot version."""
    x0, y0, x1, y1 = rects.float().unbind(-1)
    keep = live_slots(q_rects, q_amps)
    keep[:, 0] |= ~keep.any(dim=1)
    acc = torch.zeros_like(x0)
    for b in range(acc.shape[0]):
        for j in torch.nonzero(keep[b]).flatten().tolist():
            acc[b] = _slot_term(acc[b], x0[b], y0[b], x1[b], y1[b], q_rects[b, j], q_amps[b, j])
    return acc * amps.float()


HUGE = 3.0e38  # a query extent of 2·HUGE overflows f32


def adversarial_case(rng: np.random.Generator, T: int, n_live: int):
    """Test aid: numpy f32 inputs (rects [3, T, 4], amps [3, T], q_rects
    [3, Q_MAX, 4], q_amps [3, Q_MAX]) for the live-slot rule.  Query row
    0: ``n_live`` live slots at random places (with n_live ≥ 2 one of
    infinite extent and negative amp), the dead ones amp-0 rects with real
    extents or zeros; row 1: ``n_live`` live slots, one a zero-amp slot
    whose extent area overflows (live: NaN where it meets a huge rect), the
    dead ones with −0 amps; row 2: no live slot.  Each row's store holds
    NaN, ±inf and huge coordinates and a −0 amp among ordinary rects (at
    T = 1 row 2's one rect has a NaN x0: the kernel's slot-0 rule)."""

    def rects(n):
        lo = rng.uniform(0, 0.9, (n, 2)).astype(np.float32)
        return np.concatenate([lo, lo + rng.uniform(0.01, 0.2, (n, 2)).astype(np.float32)], 1)

    qr = np.zeros((3, Q_MAX, 4), np.float32)
    qa = np.zeros((3, Q_MAX), np.float32)
    for b in range(2):
        pos = rng.choice(Q_MAX, n_live, replace=False)
        qr[b, pos] = rects(n_live)
        qa[b, pos] = rng.uniform(0.5, 2.0, n_live)
        dead = np.setdiff1d(np.arange(Q_MAX), pos)
        qr[b, dead[::2]] = rects(len(dead[::2]))
        if b == 0 and n_live >= 2:
            qr[0, pos[0]], qa[0, pos[0]] = (-HUGE, 0.0, HUGE, 1.0), -1.5
        if b == 1:
            qr[1, pos[0]], qa[1, pos[0]] = (-HUGE, -HUGE, HUGE, HUGE), 0.0
            qa[1, dead] = -0.0
    qr[2, ::2] = rects(Q_MAX // 2)
    qa[2, 1::2] = -0.0
    store = rects(3 * T).reshape(3, T, 4)
    amps = rng.uniform(-0.2, 1.0, (3, T)).astype(np.float32)
    bad = [(slice(0, 1), np.nan), (slice(3, 4), np.nan),
           (slice(None), (-np.inf, -np.inf, np.inf, np.inf)),
           (slice(None), (-HUGE, -HUGE, HUGE, HUGE)),
           (slice(0, 1), np.inf), (slice(3, 4), -np.inf), None]
    for b, first in enumerate((2, 3, 0)):
        for kind, p in zip(np.roll(np.arange(len(bad)), -first), rng.permutation(T)):
            if bad[kind] is None:
                amps[b, p] = -0.0
            else:
                store[b, p, bad[kind][0]] = bad[kind][1]
    return store, amps, qr, qa
