"""Typed runtime configuration.

Copy of bellman_mpc_tpu/config.py: `Config`, `Config.from_env` and the
cached `get_config`, field for field.  The reference's knobs are Cargo
features (`groth16`, `multicore` — bellman/Cargo.toml:39-42), the
RAYON_NUM_THREADS env var and a toolchain pin; the framework's knobs are
environment variables.  Nothing reads `get_config()`: the modules below read
their variable at call time (or at a prover's construction), so a caller may
set one per call.

  BMT_NUM_THREADS      host worker threads (parallel/worker.py)
  BMT_MSM_STRATEGY     "auto" | "ladder" | "table" | "rns" | "pippenger" |
                       "flatpip", as BatchProver's msm_strategy argument
                       takes them (auto = rns on a CUDA engine, ladder on
                       the CPU); "pippenger" routes host MSMs of 64 bases
                       or more to the bucket method (ops/msm.msm_host)
  BMT_PIPPENGER_C      window bits for Pippenger buckets (default 8, as
                       BatchProver's pippenger_c argument)
  BMT_TABLE_C          window bits of the gather tables (default: the
                       largest width that fits BMT_TABLE_MEM_MB, 1536)
  BMT_TABLE_SIGNED     "0" takes unsigned digits under the table strategy
  BMT_MESH_SHAPE       "data,model" extents for make_mesh, e.g. "4,2"
                       (parsed here and read by nothing, as in the
                       reference)
  BMT_DETERMINISTIC    "1" (default) keeps the fork's fixed trapdoor/blinding
  BMT_CARRIES          "scan" | "flat" carry strategy (fields/limb.py)
  BMT_FIXED_BASE       "comb" opts into comb-table fixed-base multiplication
  BMT_GLV              "1": GLV-2 / GLS-4 tables under the rns strategy
  BMT_MERGE_G1         "1": the four G1 MSMs fold as one under rns
  BMT_STACK_MSMS       "1" stacks the prove-step G1 MSMs (ladder, pippenger)
  BMT_LOG              "debug" for verbose logging (utils/profiling.py)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    num_threads: Optional[int] = None
    msm_strategy: str = "auto"
    pippenger_c: int = 8
    mesh_shape: Optional[Tuple[int, int]] = None
    deterministic: bool = True

    @staticmethod
    def from_env() -> "Config":
        mesh = os.environ.get("BMT_MESH_SHAPE")
        return Config(
            num_threads=(
                int(os.environ["BMT_NUM_THREADS"])
                if "BMT_NUM_THREADS" in os.environ
                else None
            ),
            msm_strategy=os.environ.get("BMT_MSM_STRATEGY", "auto"),
            pippenger_c=int(os.environ.get("BMT_PIPPENGER_C", "8")),
            mesh_shape=(
                tuple(int(x) for x in mesh.split(",")) if mesh else None
            ),
            deterministic=os.environ.get("BMT_DETERMINISTIC", "1") == "1",
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config
