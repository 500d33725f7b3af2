"""The contract batch shared by every pricer: a frozen dataclass of tensors.

``cp`` encodes the option type as +1.0 (call) / -1.0 (put), so call/put is a
data axis rather than a Python branch and a mixed book prices in one pass.
Fields may be 0-d or shaped tensors; :meth:`ContractBatch.broadcast` expands
all of them to one common shape. All fields live on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .utils.config import DEFAULT_DTYPE
from .utils.validation import check_option_type

FIELDS = ("spot", "strike", "maturity", "rate", "vol", "dividend", "cp")


def _cp_tensor(option_type: Any, dtype, device) -> torch.Tensor:
    """Normalize option_type ('call'/'put'/±1/sequence of either) to ±1."""
    if isinstance(option_type, str):
        return torch.tensor(float(check_option_type(option_type)), dtype=dtype, device=device)
    if isinstance(option_type, (list, tuple)) and option_type and isinstance(option_type[0], str):
        return torch.tensor([float(check_option_type(t)) for t in option_type],
                            dtype=dtype, device=device)
    return torch.as_tensor(option_type, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ContractBatch:
    """A batch of vanilla option contracts as broadcastable tensors."""

    spot: torch.Tensor
    strike: torch.Tensor
    maturity: torch.Tensor
    rate: torch.Tensor
    vol: torch.Tensor
    dividend: torch.Tensor
    cp: torch.Tensor

    # -- constructors -------------------------------------------------------
    @classmethod
    def make(cls, spot, strike, maturity, rate, vol, option_type="call", dividend=0.0,
             dtype=None, device=None) -> "ContractBatch":
        dtype = dtype or DEFAULT_DTYPE

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return cls(spot=t(spot), strike=t(strike), maturity=t(maturity), rate=t(rate),
                   vol=t(vol), dividend=t(dividend),
                   cp=_cp_tensor(option_type, dtype, device))

    @classmethod
    def single(cls, S, K, T, r, sigma, option_type="call", q=0.0, dtype=None,
               device=None) -> "ContractBatch":
        """One contract from scalars."""
        return cls.make(S, K, T, r, sigma, option_type, q, dtype, device)

    @classmethod
    def from_numpy(cls, fields: dict[str, np.ndarray], device=None) -> "ContractBatch":
        """A batch from numpy arrays keyed by field name, keeping their dtype.

        ``{k: np.asarray(getattr(jax_batch, k)) for k in FIELDS}`` carries a
        book built with the JAX package across unchanged.
        """
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device) for k in FIELDS})

    # -- structure ----------------------------------------------------------
    def _fields(self) -> list[torch.Tensor]:
        return [getattr(self, k) for k in FIELDS]

    def broadcast(self) -> "ContractBatch":
        return ContractBatch(*torch.broadcast_tensors(*self._fields()))

    @property
    def shape(self) -> tuple:
        return tuple(torch.broadcast_shapes(*(f.shape for f in self._fields())))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def dtype(self) -> torch.dtype:
        return torch.promote_types(torch.promote_types(self.spot.dtype, self.strike.dtype),
                                   self.vol.dtype)

    @property
    def device(self) -> torch.device:
        return self.spot.device

    def astype(self, dtype) -> "ContractBatch":
        return ContractBatch(*(f.to(dtype) for f in self._fields()))

    def replace(self, **kwargs) -> "ContractBatch":
        return dataclasses.replace(self, **{
            k: torch.as_tensor(v, dtype=self.dtype, device=self.device) for k, v in kwargs.items()})

    # -- payoff helpers ------------------------------------------------------
    def intrinsic(self, underlying=None) -> torch.Tensor:
        """cp * (S - K) clipped at 0; optionally against a simulated underlying.

        If ``underlying`` carries extra trailing axes (e.g. a path axis of
        shape ``batch.shape + (n_paths,)``), contract fields are unsqueezed
        on the right to align.
        """
        if underlying is None:
            return torch.clamp_min(self.cp * (self.spot - self.strike), 0.0)
        cp, strike = self.cp, self.strike
        for _ in range(max(underlying.dim() - len(self.shape), 0)):
            cp = cp[..., None]
            strike = strike[..., None]
        return torch.clamp_min(cp * (underlying - strike), 0.0)

    def discount(self) -> torch.Tensor:
        return torch.exp(-self.rate * self.maturity)

    def forward(self) -> torch.Tensor:
        return self.spot * torch.exp((self.rate - self.dividend) * self.maturity)
