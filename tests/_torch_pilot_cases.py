"""Seeded pilot runs shared by the CPU and the card tests of the pilot
kernel (no JAX here: the card tests import this module too)."""
import numpy as np

SIZES = (1, 2, 3, 255, 1000, 4097, 65_537, 1_000_000)
CASES = ("normal", "constant", "negative", "far")


def run(case: str, n: int) -> np.ndarray:
    """A float64 run of ``n`` samples from a seed: normal(0.8, 0.1), the
    constant 3.7, an all-negative gamma run, or normal(1234.5, 17) (centred
    far from 0)."""
    rng = np.random.default_rng(1000 + n)
    if case == "normal":
        return rng.normal(0.8, 0.1, n)
    if case == "constant":
        return np.full(n, 3.7)
    if case == "negative":
        return -rng.gamma(2.0, 3.0, n) - 0.5
    return rng.normal(1234.5, 17.0, n)
