"""Turner-2004 nearest-neighbor thermodynamic parameters.

Raw integer tables (units: 10*cal/mol at 37C) are loaded from
``priblast_tpu/data/thermo.npz`` (published constants, see
http://www.cs.ubc.ca/labs/beta/Projects/RNA-Params; same values as the
reference's energy_par.hpp / intloops.hpp data headers).

Two views are exposed:

- :data:`RAW` — the integer tables as numpy arrays, used by the hybridization
  energy model of the extension kernels (reference divides by 100 to kcal/mol,
  e.g. src/ungapped_extension.cpp:185).
- :func:`scaled` — the Boltzmann-scaled floating point view used by the
  accessibility DP (energies multiplied by -10/kT so that "adding energies"
  becomes adding log-Boltzmann weights; reference: src/raccess.hpp:105-158).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent / "thermo.npz"

GASCONST = 1.98717  # cal/(K*mol)
K0 = 273.15
TEMPERATURE = 37
KT = (TEMPERATURE + K0) * GASCONST
INF = 1000000
TURN = 3
MAXLOOP = 30
LXC37 = 107.856  # logarithmic loop-energy extrapolation coefficient


class _Raw:
    """Lazy accessor for the raw integer tables."""

    def __init__(self) -> None:
        self._z = None

    def _load(self):
        if self._z is None:
            with np.load(_DATA) as z:
                self._z = {k: z[k] for k in z.files}
        return self._z

    def __getattr__(self, name: str):
        z = self._load()
        if name in z:
            arr = z[name]
            setattr(self, name, arr)  # cache
            return arr
        raise AttributeError(name)


RAW = _Raw()


@dataclasses.dataclass(frozen=True)
class ScaledParams:
    """Boltzmann-scaled (-energy*10/kT) float64 parameter set for the
    accessibility DP. Field names match the quantities in the recurrences."""

    hairpin: np.ndarray  # (31,)
    mismatch_h: np.ndarray  # (7,5,5)
    mismatch_i: np.ndarray  # (7,5,5)
    stack: np.ndarray  # (7,7)
    bulge: np.ndarray  # (31,)
    internal: np.ndarray  # (31,)
    int11: np.ndarray  # (8,8,5,5)
    int21: np.ndarray  # (8,8,5,5,5)
    int22: np.ndarray  # (8,8,5,5,5,5)
    dangle5: np.ndarray  # (8,5)
    dangle3: np.ndarray  # (8,5)  (already includes TermAU for AU/GU closings)
    ninio: np.ndarray  # (31,)
    ml_closing: float
    ml_intern: float
    ml_base: float
    term_au: float
    kT: float = KT
    lxc: float = LXC37


@functools.lru_cache(maxsize=1)
def scaled() -> ScaledParams:
    r = RAW
    kT = KT
    term_au = -int(r.TerminalAU) * 10 / kT

    dangle5 = -r.dangle5_37.astype(np.float64) * 10.0 / kT
    dangle3 = -r.dangle3_37.astype(np.float64) * 10.0 / kT
    # Reference folds the terminal-AU penalty for wobble/AU closing pairs
    # (pair types 3..6) into dangle3 (src/raccess.hpp:132-134). Note it only
    # does so for i in 0..6 (the 7-iteration loop), leaving dangle3[7] as-is.
    dangle3[3:7, :] += term_au

    return ScaledParams(
        hairpin=-r.hairpin37.astype(np.float64) * 10.0 / kT,
        mismatch_h=-r.mismatchH37.astype(np.float64) * 10.0 / kT,
        mismatch_i=-r.mismatchI37.astype(np.float64) * 10.0 / kT,
        stack=-r.stack37.astype(np.float64) * 10.0 / kT,
        bulge=-r.bulge37.astype(np.float64) * 10.0 / kT,
        internal=-r.internal_loop37.astype(np.float64) * 10.0 / kT,
        int11=-r.int11_37.astype(np.float64) * 10.0 / kT,
        int21=-r.int21_37.astype(np.float64) * 10.0 / kT,
        int22=-r.int22_37.astype(np.float64) * 10.0 / kT,
        dangle5=dangle5,
        dangle3=dangle3,
        ninio=-np.minimum(int(r.MAX_NINIO), np.arange(MAXLOOP + 1) * int(r.F_ninio37)).astype(np.float64) * 10 / kT,
        ml_closing=-int(r.ML_closing37) * 10 / kT,
        ml_intern=-int(r.ML_intern37) * 10.0 / kT,
        ml_base=-int(r.ML_BASE37) * 10.0 / kT,
        term_au=term_au,
    )
