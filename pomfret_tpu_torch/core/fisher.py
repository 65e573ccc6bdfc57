"""Fisher's exact test, decision-equivalent with htslib's kt_fisher_exact
(borrowed by the reference at blockjoin.c:10, 3926).

Implemented from the standard hypergeometric tail-walk formulation with
lgamma; the reference only consumes the two-sided p against EVAL_P_THRE=0.001
(blockjoin.c:3928), so decision equivalence is what matters.
"""
from __future__ import annotations

import math


def _lbinom(n: int, k: int) -> float:
    if k == 0 or n == k:
        return 0.0
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _hypergeo(n11: int, n1_: int, n_1: int, n: int) -> float:
    return math.exp(_lbinom(n1_, n11) + _lbinom(n - n1_, n_1 - n11) - _lbinom(n, n_1))


def kt_fisher_exact(n11: int, n12: int, n21: int, n22: int):
    """Return (left, right, two) tail p-values (htslib tail-walk semantics)."""
    n1_ = n11 + n12
    n_1 = n11 + n21
    n = n11 + n12 + n21 + n22
    mx = min(n_1, n1_)
    mn = n1_ + n_1 - n
    if mn < 0:
        mn = 0
    if mn == mx:
        return 1.0, 1.0, 1.0
    q = _hypergeo(n11, n1_, n_1, n)

    # left tail
    p = _hypergeo(mn, n1_, n_1, n)
    left = 0.0
    i = mn + 1
    while p < 0.99999999 * q and i <= mx:
        left += p
        p = _hypergeo(i, n1_, n_1, n)
        i += 1
    i -= 1
    if p < 1.00000001 * q:
        left += p
    else:
        i -= 1

    # right tail
    p = _hypergeo(mx, n1_, n_1, n)
    right = 0.0
    j = mx - 1
    while p < 0.99999999 * q and j >= 0:
        right += p
        p = _hypergeo(j, n1_, n_1, n)
        j -= 1
    j += 1
    if p < 1.00000001 * q:
        right += p
    else:
        j += 1

    two = left + right
    if two > 1.0:
        two = 1.0
    if abs(i - n11) < abs(j - n11):
        right = 1.0 - left + q
    else:
        left = 1.0 - right + q
    return left, right, two
