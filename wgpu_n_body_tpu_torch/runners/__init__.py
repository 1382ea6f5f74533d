"""Drivers: headless step loop, trajectory IO."""

from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader, TrajectoryWriter

__all__ = ["OfflineHeadless", "TrajectoryWriter", "TrajectoryReader"]
