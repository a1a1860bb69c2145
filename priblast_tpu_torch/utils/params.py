"""Pipeline configuration dataclasses, mirroring the reference CLIs.

Defaults match the reference (db: src/db_construction_parameters.hpp:46-49,
ris: src/rna_interaction_search_parameters.hpp:53-60). The ris step inherits
the database-time parameters (hash size, repeat flag, maximal span, minimal
accessible length) from the ``.bas`` file rather than flags — a real coupling
the search must keep (src/rna_interaction_search_parameters.cpp:97-114).

``engine`` picks the exact host engine or the PyTorch device engine
(``gpu``); ``auto``, the default, is the device engine (resolve_engine);
``device`` names the kind of torch device the ``gpu`` engine runs on:
``cuda`` (every card the process owns, parallel/dist.py:local_devices) or
``cpu``.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

ENGINES = ("auto", "gpu", "exact")
DEVICES = ("cuda", "cpu")


def resolve_engine(engine: str) -> str:
    """`auto` -> the device engine (`gpu`), on whatever `device` names;
    `gpu` and `exact` stay. The JAX package's `auto` takes the exact host
    engine where it finds no accelerator; here that would be a silent
    switch to the CPU, which the port never makes: with `--device cuda`
    and no card the device engine raises (parallel/dist.py:local_devices),
    naming `--device cpu` and `--engine exact`."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return "gpu" if engine == "auto" else engine


@dataclasses.dataclass
class DbParams:
    input: str = ""
    db_name: str = ""
    hash_size: int = 8
    repeat_flag: int = 0
    maximal_span: int = 70
    min_accessible_length: int = 5
    chunk_size: int = 2**31 - 1
    algorithm: str = "heap"
    tmp_path: str = ""
    engine: str = "auto"     # auto (= gpu) | gpu | exact
    device: str = "cuda"     # cuda | cpu (gpu engine only)

    def __post_init__(self) -> None:
        self.engine = resolve_engine(self.engine)

    def validate(self) -> None:
        if not self.db_name:
            raise SystemExit("Error: -o option is required")
        if self.min_accessible_length <= 1:
            raise SystemExit("Error: -d option must be greater than 1")
        if self.repeat_flag not in (0, 1, 2):
            raise SystemExit("Error: -r option must be 0, 1, or 2")


@dataclasses.dataclass
class RisParams:
    input: str = ""
    output: str = ""
    db_name: str = ""
    max_seed_length: int = 20
    interaction_energy_threshold: float = -4.0
    hybrid_energy_threshold: float = -6.0
    final_threshold: float = -8.0
    drop_out_length_wo_gap: int = 5
    drop_out_length_w_gap: int = 16
    min_helix_length: int = 3
    output_style: int = 0
    algorithm: str = "area"
    tmp_path: str = ""
    engine: str = "auto"     # auto (= gpu) | gpu | exact
    device: str = "cuda"     # cuda | cpu (gpu engine only)
    # device-engine working dtype: float32, or float64 for ~1e-9 kcal/mol
    # agreement with the exact engine's accessibility
    dtype: str = "float32"
    # inherited from the db's .bas file:
    hash_size: int = 0
    repeat_flag: int = 0
    maximal_span: int = 0
    min_accessible_length: int = 0

    def __post_init__(self) -> None:
        self.engine = resolve_engine(self.engine)

    def load_db_params(self) -> None:
        bas = Path(self.db_name + ".bas")
        if not bas.exists():
            raise SystemExit(f"Error: can't open {self.db_name}.bas")
        h, r, w, d = struct.unpack("<4i", bas.read_bytes()[:16])
        self.hash_size, self.repeat_flag = h, r
        self.maximal_span, self.min_accessible_length = w, d
