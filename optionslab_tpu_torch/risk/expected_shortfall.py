"""Expected shortfall (CVaR): historical, Gaussian parametric
(−μ + σ·φ(z)/(1−α)) and Monte Carlo, as static methods (the port of
``optionslab_tpu/risk/expected_shortfall.py``)."""

from __future__ import annotations

import torch

from ..utils.config import input_device
from .var import historical_es, monte_carlo_var, parametric_es


class ExpectedShortfall:
    @staticmethod
    def historical(pnl, confidence: float = 0.95) -> float:
        return float(historical_es(pnl, confidence))

    @staticmethod
    def parametric(mu, sigma, confidence: float = 0.95, horizon: float = 1.0) -> float:
        return float(parametric_es(mu, sigma, confidence, horizon))

    @staticmethod
    def monte_carlo(value, mu, sigma, confidence: float = 0.95, horizon: float = 1.0,
                    n_paths: int = 100_000, seed: int = 0) -> float:
        """On the device of the tensor arguments (the card for numbers)."""
        gen = torch.Generator(device=input_device(value, mu, sigma)).manual_seed(seed)
        _, es = monte_carlo_var(value, mu, sigma, gen, confidence, horizon, n_paths,
                                return_es=True)
        return float(es)
