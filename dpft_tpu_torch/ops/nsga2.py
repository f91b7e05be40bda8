"""Self-contained NSGA-II multi-objective optimizer (numpy).

Replaces the reference's pymoo dependency for the dataset split optimizer
(reference scripts/split_dataset.py:24-243: integer-coded NSGA2 with
simulated-binary crossover and polynomial mutation plus rounding repair).
Implements the standard algorithm: fast non-dominated sorting, crowding
distance, binary tournament with constraint domination, SBX crossover and
polynomial mutation on a float relaxation that is rounded back to the
integer design space.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def fast_non_dominated_sort(F: np.ndarray) -> List[np.ndarray]:
    """F: (P, O) objective values -> list of index arrays per front."""
    P = F.shape[0]
    dominates = ((F[:, None, :] <= F[None, :, :]).all(-1)
                 & (F[:, None, :] < F[None, :, :]).any(-1))
    n_dominated = dominates.sum(axis=0)  # times i is dominated
    fronts = []
    remaining = np.ones(P, bool)
    counts = n_dominated.copy()
    while remaining.any():
        front = np.where(remaining & (counts == 0))[0]
        if front.size == 0:  # numerical degeneracy guard
            front = np.where(remaining)[0]
        fronts.append(front)
        remaining[front] = False
        counts = counts - dominates[front].sum(axis=0)
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """Crowding distance of points within one front. F: (N, O)."""
    N, O = F.shape
    dist = np.zeros(N)
    for o in range(O):
        order = np.argsort(F[:, o])
        span = F[order[-1], o] - F[order[0], o]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0 and N > 2:
            dist[order[1:-1]] += (F[order[2:], o] - F[order[:-2], o]) / span
    return dist


def _tournament(rng, fitness_rank, crowd, cv):
    """Binary tournament: feasibility first, then rank, then crowding."""
    P = len(fitness_rank)
    a, b = rng.integers(0, P, 2)
    if cv[a] != cv[b]:
        return a if cv[a] < cv[b] else b
    if fitness_rank[a] != fitness_rank[b]:
        return a if fitness_rank[a] < fitness_rank[b] else b
    return a if crowd[a] >= crowd[b] else b


def _sbx(rng, p1, p2, xl, xu, eta=3.0, prob=1.0):
    u = rng.uniform(size=p1.shape)
    beta = np.where(u <= 0.5,
                    (2 * u) ** (1 / (eta + 1)),
                    (1 / (2 * (1 - u))) ** (1 / (eta + 1)))
    do = rng.uniform(size=p1.shape) < prob
    c1 = np.where(do, 0.5 * ((1 + beta) * p1 + (1 - beta) * p2), p1)
    c2 = np.where(do, 0.5 * ((1 - beta) * p1 + (1 + beta) * p2), p2)
    return np.clip(c1, xl, xu), np.clip(c2, xl, xu)


def _poly_mutation(rng, x, xl, xu, eta=3.0, prob=1.0):
    """Standard polynomial mutation (Deb & Goyal; pymoo's PM operator):
    delta shrinks with the gene's distance to its nearer bound, so genes
    near a bound perturb inward instead of piling clipped mass onto it."""
    span = max(xu - xl, 1e-12)
    d1 = (x - xl) / span
    d2 = (xu - x) / span
    u = rng.uniform(size=x.shape)
    mut_pow = 1.0 / (eta + 1.0)
    lo = 2 * u + (1 - 2 * u) * (1 - d1) ** (eta + 1.0)
    hi = 2 * (1 - u) + 2 * (u - 0.5) * (1 - d2) ** (eta + 1.0)
    delta = np.where(u < 0.5, lo ** mut_pow - 1.0, 1.0 - hi ** mut_pow)
    do = rng.uniform(size=x.shape) < prob / max(x.shape[-1], 1)
    return np.clip(np.where(do, x + delta * span, x), xl, xu)


def nsga2_minimize(evaluate: Callable[[np.ndarray],
                                      Tuple[np.ndarray, float]],
                   n_var: int, xl: int, xu: int,
                   pop_size: int = 100, n_gen: int = 1000,
                   seed: int = 42,
                   verbose: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Minimizes a multi-objective integer problem.

    Arguments:
        evaluate: x (n_var,) int -> (objectives (O,), constraint violation).
        n_var, xl, xu: design-space size and integer bounds (inclusive).

    Returns:
        (X (P, n_var), F (P, O)) final population, rank-sorted.
    """
    rng = np.random.default_rng(seed)
    X = rng.integers(xl, xu + 1, size=(pop_size, n_var)).astype(float)

    def eval_pop(Xp):
        F, CV = [], []
        for x in np.rint(Xp).astype(int):
            f, cv = evaluate(x)
            F.append(np.asarray(f, float))
            CV.append(float(cv))
        return np.asarray(F), np.asarray(CV)

    F, CV = eval_pop(X)

    for gen in range(n_gen):
        fronts = fast_non_dominated_sort(F)
        rank = np.zeros(pop_size, int)
        crowd = np.zeros(pop_size)
        for r, front in enumerate(fronts):
            rank[front] = r
            crowd[front] = crowding_distance(F[front])

        # Offspring
        children = []
        while len(children) < pop_size:
            i = _tournament(rng, rank, crowd, CV)
            j = _tournament(rng, rank, crowd, CV)
            c1, c2 = _sbx(rng, X[i], X[j], xl, xu)
            children.append(_poly_mutation(rng, c1, xl, xu))
            children.append(_poly_mutation(rng, c2, xl, xu))
        Xc = np.rint(np.asarray(children[:pop_size]))
        Fc, CVc = eval_pop(Xc)

        # Environmental selection over the union
        Xu_ = np.vstack([X, Xc])
        Fu = np.vstack([F, Fc])
        CVu = np.concatenate([CV, CVc])

        # Constraint domination: feasible solutions strictly precede
        # infeasible ones (sorted by violation).
        feas = CVu <= 1e-9
        ordered = []
        if feas.any():
            idx_f = np.where(feas)[0]
            for front in fast_non_dominated_sort(Fu[idx_f]):
                cd = crowding_distance(Fu[idx_f][front])
                ordered.extend(idx_f[front[np.argsort(-cd)]].tolist())
        idx_i = np.where(~feas)[0]
        ordered.extend(idx_i[np.argsort(CVu[idx_i])].tolist())

        sel = np.asarray(ordered[:pop_size])
        X, F, CV = Xu_[sel], Fu[sel], CVu[sel]

        if verbose and gen % 50 == 0:
            print(f"gen {gen}: best sum(F)={F.sum(1).min():.4f} "
                  f"feasible={int((CV <= 1e-9).sum())}/{pop_size}")

    return np.rint(X).astype(int), F
