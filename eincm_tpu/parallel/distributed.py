"""Multi-host (multi-process) runtime initialization.

The reference is strictly single-process (SURVEY.md §2.3: no distributed
imports anywhere). For multi-host GPU clusters the JAX-native path is
`jax.distributed.initialize`: every host process connects to a coordinator,
after which `jax.devices()` spans every host and the `Mesh`-based solvers in
`eincm_tpu.parallel.batch` shard over NVLink / the network transparently —
the window axis is data-parallel, so no code change is needed beyond
building the mesh from the global device list.

Gated behind `DistributedConfig.enable` so single-host runs (and the test
suite) never touch the coordinator machinery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax

_INITIALIZED = False


@dataclass(frozen=True)
class DistributedConfig:
    """Multi-process runtime settings (see experiments.config for YAML keys).

    With every field None, `jax.distributed.initialize` auto-detects the
    cluster environment (SLURM, Open MPI, etc.); explicit values
    support manual bring-up:

        coordinator_address: "host:port" of process 0.
        num_processes: world size.
        process_id: this process's rank.
        local_device_ids: restrict this process to a subset of local devices.
    """

    enable: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[tuple] = None


def initialize_distributed(cfg: DistributedConfig) -> bool:
    """Initialize the multi-process runtime if enabled; returns True if the
    process is (now) part of a multi-process cluster.

    Must run before the first backend touch (same constraint as platform
    selection). Safe to call more than once.
    """
    global _INITIALIZED
    if not cfg.enable:
        return False
    if _INITIALIZED:
        return is_multi_process()
    kwargs = {}
    if cfg.coordinator_address is not None:
        kwargs["coordinator_address"] = cfg.coordinator_address
    if cfg.num_processes is not None:
        kwargs["num_processes"] = cfg.num_processes
    if cfg.process_id is not None:
        kwargs["process_id"] = cfg.process_id
    if cfg.local_device_ids is not None:
        kwargs["local_device_ids"] = list(cfg.local_device_ids)
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    # the contract is "True iff part of a multi-process cluster" — an
    # enabled-but-single-process init (num_processes=1, or auto-detect
    # resolving to one process) must not steer callers onto a
    # multi-process branch
    return is_multi_process()


def is_multi_process() -> bool:
    return jax.process_count() > 1


def process_info() -> str:
    return (
        f"process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )
