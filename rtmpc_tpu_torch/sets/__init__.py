"""Invariant-set algorithms of the port's host setup, its own copy of
``rtmpc_tpu.sets``."""

from .invariant import (
    mrpi_rakovic,
    rpi_darup,
    max_admissible_set,
    determine_mrpi,
    tighten_constraints,
)

__all__ = ["mrpi_rakovic", "rpi_darup", "max_admissible_set",
           "determine_mrpi", "tighten_constraints"]
