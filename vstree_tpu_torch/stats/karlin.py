"""Karlin-Altschul statistics for score-based matches.

Re-derivation of reference kurtz/karlin.c: ``karlinpp`` computes the
(lambda, K) parameters of the Karlin-Altschul extreme-value statistic
for an integer-score distribution, ``karlinunitcostpp`` (karlin.c:191)
instantiates it for the unit-cost DNA model (match +2 with probability
1/4, mismatch -1 with probability 3/4), and ``significance``
(karlin.c:198) converts a score into the P-value
``exp(-K * m * exp(-lambda * score))``.

In the reference these are exercised by kurtz/libtest/checkEvalue.c;
the vmatch output path derives x-drop E-values through the
distance-model machinery (stats/evalues.py), which our differential
tests verify byte-identically — karlin is the score-statistics
library surface.
"""

from __future__ import annotations

import math

MAXIT = 150


def _gcd(a: int, b: int) -> int:
    return math.gcd(a, abs(b))


def karlinpp(low: int, high: int, pr: list[float]) -> tuple[float, float]:
    """karlinpp (karlin.c:36-189): (lambda, K) for the score
    distribution pr[i] = P(score == low + i).  Raises ValueError on
    the reference's error conditions."""
    if low >= 0:
        raise ValueError(f"Lowest score {low} must be negative")
    rng = high - low
    i = rng
    while i > -low and not pr[i]:
        i -= 1
    if i <= -low:
        raise ValueError("A positive score must be possible")
    total = 0.0
    for i in range(rng + 1):
        if pr[i] < 0.0:
            raise ValueError(f"Negative probability {pr[i]:.2f}")
        total += pr[i]
    p = [pr[i] / total for i in range(rng + 1)]
    sumval = float(low)
    for i in range(rng + 1):
        sumval += i * p[i]
    if sumval >= 0.0:
        raise ValueError(
            f"Invalid (non-negative) expected score: {sumval:.3f}")

    # lambda by bisection (karlin.c:86-111)
    upval = 0.5
    while True:
        upval *= 2
        s = sum(p[i - low] * math.exp(upval * i)
                for i in range(low, high + 1))
        if s >= 1.0:
            break
    lam = 0.0
    for _ in range(25):
        newval = (lam + upval) / 2.0
        s = sum(p[i - low] * math.exp(newval * i)
                for i in range(low, high + 1))
        if s > 1.0:
            upval = newval
        else:
            lam = newval

    # K (karlin.c:113-188)
    av = sum(p[i - low] * i * math.exp(lam * i)
             for i in range(low, high + 1))
    if low == -1 or high == 1:
        K = av if high == 1 else sumval * sumval / av
        K *= 1.0 - math.exp(-lam)
        return lam, K

    Sumval = 0.0
    lo = hi = 0
    P = [0.0] * (MAXIT * rng + 1)
    P[0] = 1.0
    s = 1.0
    j = 1
    while j <= MAXIT and s > 0.00001:
        first = last = rng
        hi += high
        lo += low
        # convolve the score distribution (karlin.c:139-158)
        for pidx in range(hi - lo, -1, -1):
            i1 = pidx - first
            i1e = pidx - last
            sacc = 0.0
            q = first
            ii = i1
            while ii >= i1e:
                sacc += P[ii] * p[q]
                ii -= 1
                q += 1
            P[pidx] = sacc
            # NOTE: the reference assigns the PREVIOUS sacc into
            # P[pidx] after computing (pointer post-decrement); the
            # net effect is P updated in place from high to low with
            # the freshly computed value — reproduced by ordering
            if first:
                first -= 1
            if pidx <= rng:
                last -= 1
        s = 0.0
        for i in range(lo, 0):
            s += P[i - lo] * math.exp(lam * i)
        for i in range(0, hi + 1):
            s += P[i - lo]
        # C continuation expression: Sumval += sum /= j++ — the
        # DIVIDED value is also the loop-condition value
        s /= j
        Sumval += s
        j += 1
    if j > MAXIT:
        raise ValueError(
            "Value for K may be too large due to insufficient "
            "iterations")
    i = low
    while not p[i - low]:
        i += 1
    jg = -i
    while i < high and jg > 1:
        i += 1
        if p[i - low] != 0.0:
            jg = _gcd(jg, i)
    Ktmp = jg * math.exp(-2 * Sumval)
    K = Ktmp / (av * (1.0 - math.exp(-lam * jg)))
    return lam, K


def karlinunitcostpp() -> tuple[float, float]:
    """karlinunitcostpp (karlin.c:191-196): unit-cost DNA model."""
    return karlinpp(-1, 2, [0.75, 0.0, 0.0, 0.25])


def significance(lam: float, K: float, multiplier: float,
                 score: int) -> float:
    """significance (karlin.c:198-205): P-value of a score."""
    y = K * multiplier * math.exp(-lam * score)
    return math.exp(-y)
