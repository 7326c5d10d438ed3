"""Device mesh helpers for data-parallel scale-out.

The reference is a single-process realtime engine; its concurrency fabric
(SPSC rings + SlotPool SPMC fan-out, ref src/audio_io/mod.rs:299-314,480-495)
has no distributed analog.  Scale-out here is data parallelism over the
stream/batch axis: each chip analyzes a shard of independent audio streams
(BASELINE config #5 "batched streaming analysis"), with collectives only for
fleet-wide aggregate statistics over a 1-D mesh (NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (stream/batch) axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
